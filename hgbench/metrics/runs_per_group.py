"""trainer: runs folded into each group of the traced job, as
``Trainer.fit`` chose them (``Results.groups``), averaged over its
groups."""


def read(ctx):
    return sum(ctx.groups) / len(ctx.groups) if ctx.groups else None
