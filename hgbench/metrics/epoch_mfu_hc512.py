"""whole epoch, in the HC 512 cell: percent of the dense TF32 peak (495
TFLOP/s) in the matrix-product FLOPs of one epoch of all runs
(``costs.epoch_flops``: the training forward, the backward's two products
per product, the evaluation forward) over the traced job's time per
epoch; ``epoch_mfu``'s arithmetic."""

from hgbench import costs


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * costs.epoch_flops(ctx.shapes) / (ctx.window_s / ctx.epochs) / costs.TF32
