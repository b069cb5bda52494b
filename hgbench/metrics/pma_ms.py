"""pma epilogue: device ms per epoch of the PMA epilogue's kernels, K2R,
K3R's parts (K3a, K3b, K3c) and the score+pack K4/K5 (``ops/cuda_pma.py``,
``ops/cuda_pack.py``), from the traced job. The patterns are the kernels'
name prefixes in ``allset_tpu_torch/csrc/`` at commit b978a993e545."""

PATTERNS = ("pma_fwd", "pma_bwd", "dw_wg", "dw_partial", "reduce_partials", "gmax",
            "pack_kernel", "wide_")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    return ctx.ms_per_epoch(s) if s > 0 else None
