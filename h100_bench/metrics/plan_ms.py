"""Plan: ``strategy.plan`` (selection, order, LR factor, the plan's one
fetch), ms a call, mean over the window's epochs."""
from h100_bench.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.spans.get("plan", []))
