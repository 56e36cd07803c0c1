"""Trainer epoch: an epoch's wall time outside ``engine.run_epoch`` (plan,
refresh, the epoch's bookkeeping), ms, mean over the window's epochs."""
from h100_bench.readers import mean_ms


def read(ctx):
    ep, en = ctx.spans.get("epoch", []), ctx.spans.get("engine", [])
    if not ep or len(ep) != len(en):
        return None
    return mean_ms([a - b for a, b in zip(ep, en)])
