"""Run one cell of ``BENCHMARK.json`` once on this machine's GPU.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``, from this process's start): the kernel
library (built once a checkout into ``build/repro_torch/``), the corpus and
the weights from the seed, the program's ``Trainer`` and epochs 0 and 1
(``session.py``).  The window: whole epochs until ``--seconds`` have
passed.  ``--trace 1`` times the program's layers
from the benchmark's own wrappers and profiles one more epoch, and
reports the per-layer metrics instead of the end-to-end ones.  Then the
program's state is freed and the plain reference judges what the timed
path produced (``check.py``).  The last line of standard output is the
result, one JSON object; the numbers compared, each with its limit, are
also the last lines of standard error.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from h100_bench import cells, check, readers, trace  # noqa: E402
from h100_bench.session import Session  # noqa: E402

#: Top-level modules that may not be loaded in the process that prints the
#: result: JAX, its libraries and the JAX package (``repro``; the port's
#: ``repro_torch`` is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return got.stdout.strip() or None


def per_layer(cell, sess, prof) -> tuple[dict, dict, dict]:
    """The per-layer metrics this cell reports, the device's busy and
    window seconds, and the breakdown of the traced epoch (``prof``)."""
    acts = trace.device_activities(prof)
    hosts = trace.host_ranges(prof)
    epoch = [h for h in hosts if h.name == "bench.epoch"]
    lo, hi = ((epoch[-1].start_us, epoch[-1].end_us) if epoch
              else (min(a.start_us for a in acts), max(a.end_us for a in acts)))
    inside = [a for a in acts if a.end_us > lo and a.start_us < hi]
    window_s = (hi - lo) / 1e6
    busy = trace.busy_s([trace.Activity(a.name, max(a.start_us, lo),
                                        min(a.end_us, hi)) for a in inside])
    spans = dict(sess.spans.times)
    results = dict(sess.spans.results)
    n = len(sess.window_epochs)
    ctx = readers.Context(cell, {k: v[:n] for k, v in spans.items()},
                          {k: v[:n] for k, v in results.items()},
                          sess.window_epochs, inside, window_s, busy)
    metrics = {}
    for m in cells.per_layer_metrics(cell.name):
        value = importlib.import_module(
            f"h100_bench.metrics.{m['name']}").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": trace.top_ops(inside),
                 "idle_gaps": trace.idle_gaps(inside, hosts, lo, hi)}
    return metrics, {"busy_s": busy, "window_s": window_s}, breakdown


def run(cell: cells.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda") -> dict:
    """One run of ``cell``: the result object (without the look for a
    chip, which ``main`` makes)."""
    sess = Session(cell, seed, device, traced)
    setup_s = time.perf_counter() - T0
    print(f"setup {setup_s!r} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sess.setup_stages.items()), file=sys.stderr)
    window_s = sess.run_window(seconds)
    epochs = sess.window_epochs
    n = cell.shape["num_samples"]
    on_cuda = torch.device(device).type == "cuda"
    peak = sess.peak_bytes
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak,
           "power_limit": power_limit() if on_cuda else None}
    walls = [e.wall_time for e in epochs]
    print(f"window {window_s!r} s, {len(epochs)} epochs: "
          + ", ".join(f"{w:.4f}" for w in walls)
          + f" s; outside them {window_s - sum(walls):.4f} s", file=sys.stderr)
    line = {"correct": False, "attempted": len(epochs),
            "failed": sum(1 for e in epochs if e.train_loss != e.train_loss
                          or abs(e.train_loss) == float("inf"))}
    breakdown = None
    if traced:
        metrics, busy, breakdown = per_layer(cell, sess, sess.traced_epoch())
        dev.update(busy)
    else:
        rate = n * len(epochs) / window_s
        metrics = {"samples_per_s": {"value": rate, "unit": "samples/s"},
                   "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        names = {m["name"] for m in cells.end_to_end_metrics(cell.name)}
        metrics = {k: v for k, v in metrics.items() if k in names}
    out = sess.outputs()
    corpus = sess.corpus
    sess.close()
    numbers = check.run_checks(cell, seed, corpus, out, device)
    print(f"steps' losses: program "
          f"{check.program_readout(out)['losses']!r}, reference "
          f"{out['reference_losses']!r}", file=sys.stderr)
    for name, value in numbers.items():
        if name not in cell.limits:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    ok, table = check.verdict(numbers, cell.limits)
    line.update({"correct": ok and line["failed"] == 0, "metrics": metrics,
                 "device": dev})
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = table
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"run.py: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: the process loaded {loaded}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
