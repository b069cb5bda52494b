"""exchange: device ms per epoch of ``dir_spmm``'s kernels, the gather
inside K1 (``segment_gather_kernel``), K1 and the row gathers
(``ops/cuda_segment.py``, ``ops/cuda_gather.py``); name prefixes from
``allset_tpu_torch/csrc/`` at commit b978a993e545."""

PATTERNS = ("segment_", "gather_kernel", "gather_sorted")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    return ctx.ms_per_epoch(s) if s > 0 else None
