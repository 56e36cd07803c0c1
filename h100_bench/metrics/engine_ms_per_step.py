"""Scanned engine: ``engine.run_epoch`` time over the train steps it
dispatched, ms a step, over the window's epochs."""
from h100_bench.readers import steps


def read(ctx):
    n = sum(steps(ctx))
    t = ctx.spans.get("engine", [])
    return 1e3 * sum(t) / n if n and t else None
