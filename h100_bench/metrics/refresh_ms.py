"""Refresh: ``strategy.on_epoch_end`` (the hidden samples' forward passes,
read through the dataset's host ``get``), ms an epoch, mean over the
window's epochs."""
from h100_bench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("refresh", []))
