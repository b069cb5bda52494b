"""model: device ms per epoch of the runs-folded f32 dense products'
kernels (``ops/cuda_dense.py``: the products, dW's partials and their
reduce, the weight stages), from the traced job. Their names start with
``runs_dense_`` (``allset_tpu_torch/csrc/runs_dense.cu``), a prefix of no
name in ``torch_ops_ms``'s ``PORT``, so ``torch_ops_ms`` still counts
them in the model layer."""

PATTERNS = ("runs_dense_",)


def read(ctx):
    s = ctx.claimed(PATTERNS)
    return ctx.ms_per_epoch(s) if s > 0 else None
