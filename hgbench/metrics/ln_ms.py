"""layer norm: device ms per epoch of B12 and B13 (``ops/cuda_ln.py``);
name prefixes from ``allset_tpu_torch/csrc/layer_norm.cu`` at commit
b978a993e545."""

PATTERNS = ("ln_fwd", "ln_bwd")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    return ctx.ms_per_epoch(s) if s > 0 else None
