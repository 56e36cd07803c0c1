"""Train step: model operations of the dispatched steps
(``counts.step_flops``: 6 a matmul parameter and token plus the sequence
mixer's products, no recomputation) over engine time at the H100's dense
TF32 peak, %."""
from h100_bench import counts
from h100_bench.readers import steps


def read(ctx):
    n, t = sum(steps(ctx)), sum(ctx.spans.get("engine", []))
    if not n or not t:
        return None
    s = ctx.cell.shape
    flops = n * counts.step_flops(ctx.cell.arch, s["batch"], s["seq_len"])
    return 100.0 * flops / (t * counts.PEAK_OPS_PER_S)
