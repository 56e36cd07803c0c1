"""Paper Table 3 on the port: Grad-Match against KAKURENBO, one worker.

The counterpart of ``benchmarks/table3_gradmatch.py``: baseline, Grad-Match
(fraction 0.3, reselected every 5 epochs) and KAKURENBO (F = 0.3), each
through the Table 2 harness (``experiments/table2.make_trainer``, the
reference's ``benchmarks/common.py::run_strategy`` settings): the small
paper CNN on ``SyntheticClassification(1024)`` (test split 512), batch 128,
16 epochs.  Grad-Match's features are ``p - onehot(y)`` (``table2.feats_fn``)
and its OMP runs on the host, as in the reference; its host seconds are
reported beside each row.

    python -m repro_torch.experiments.table3 --device cpu --n 512 --epochs 4

prints one CSV row per strategy, as the reference does:
``table3/<row>,<us per epoch>,best_acc=...;time_vs_base=...;omp_s=...``.
Keep N near the reference's: the OMP re-solves a ridge system over the
picks so far at each of its 0.7 N picks, quartic in a class's size (at
N = 50,000 that is some 3,500 picks a class).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments import table2

#: Table 3's rows: (strategy, row name), baseline first.
ROWS = (("baseline", "table3/baseline"),
        ("gradmatch", "table3/gradmatch-0.3"),
        ("kakurenbo", "table3/kakurenbo-0.3"))


def run_strategy(strategy: str, **kw) -> dict:
    """Train one row of Table 3 (``table2.make_trainer``'s keywords);
    returns its history, wall seconds, accuracy, work and OMP seconds."""
    tr = table2.make_trainer(strategy, **kw)
    t0 = time.perf_counter()
    hist = tr.run()
    wall = time.perf_counter() - t0
    return {"history": hist, "wall_s": wall,
            "final_acc": hist[-1].test_acc,
            "best_acc": max(h.test_acc for h in hist if h.test_acc == h.test_acc),
            "fwd": sum(h.fwd_samples for h in hist),
            "bwd": sum(h.bwd_samples for h in hist),
            "omp_s": getattr(tr.strategy, "omp_seconds", 0.0),
            "trainer": tr}


def run_table(**kw) -> list[tuple[str, dict]]:
    """Every row of Table 3, baseline first."""
    return [(name, run_strategy(strategy, **kw)) for strategy, name in ROWS]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    ap.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = ap.parse_args(argv)
    rows = run_table(n=args.n, n_test=args.n_test, epochs=args.epochs,
                     device=args.device)
    base = rows[0][1]["wall_s"]
    for name, res in rows:
        print(table2.csv_row(name, res["wall_s"] / args.epochs * 1e6,
                             f"best_acc={res['best_acc']:.4f};"
                             f"time_vs_base={res['wall_s'] / base:.3f};"
                             f"omp_s={res['omp_s']:.4f}"), flush=True)


if __name__ == "__main__":
    main()
