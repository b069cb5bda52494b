"""model: device ms per epoch of everything on the device that no port
kernel claims: cuBLAS's GEMMs, PyTorch's elementwise passes and
reductions, Adam, copies and fills. The port's kernels are every name
prefix of ``allset_tpu_torch/csrc/`` at commit b978a993e545."""

PORT = ("pma_", "dw_wg", "dw_partial", "reduce_partials", "gmax", "pack_kernel", "wide_",
        "segment_", "gather_kernel", "gather_sorted", "ln_", "segsum_onehot", "plan_kernel",
        "combine_kernel", "stream_")


def read(ctx):
    s = ctx.unclaimed(PORT)
    return ctx.ms_per_epoch(s) if s > 0 else None
