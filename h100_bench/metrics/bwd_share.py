"""Plan: the share of the N samples that took a backward pass an epoch
(``EpochStats.bwd_samples`` / N), %, mean over the window's epochs."""


def read(ctx):
    if not ctx.epochs:
        return None
    n = ctx.cell.shape["num_samples"]
    return 100.0 * sum(e.bwd_samples for e in ctx.epochs) / (n * len(ctx.epochs))
