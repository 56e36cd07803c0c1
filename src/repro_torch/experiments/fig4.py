"""Paper Fig. 4 on the port: the hiding fraction and the speedup by epoch.

The counterpart of ``benchmarks/fig4_fraction.py``: the baseline, then
KAKURENBO at the harness's setting (``table2.kakurenbo_config``), each
through the Table 2 harness (``experiments/table2.run_strategy``: the
small paper CNN on ``SyntheticClassification(1024)``, test split 512,
batch 128, 16 epochs).  Each of KAKURENBO's epochs is set beside the
baseline's epoch of the same number.

    python -m repro_torch.experiments.fig4 --device cpu --n 256 --epochs 5

prints one CSV row per epoch, as the reference does:
``fig4/epoch<e>,<epoch us>,hidden_fraction=...;epoch_speedup=...`` (the
baseline's epoch seconds over KAKURENBO's; NaN where KAKURENBO's are 0).
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import table2

#: The harness's run function; a test substitutes it, as the reference's
#: section reaches ``benchmarks.common.run_strategy``.
run_strategy = table2.run_strategy


def run_figure(**kw) -> tuple[dict, dict]:
    """The baseline and KAKURENBO runs (``table2.run_strategy``'s
    keywords; KAKURENBO at ``table2.kakurenbo_config`` of the run's
    epochs, as the harness sets it)."""
    return run_strategy("baseline", **kw), run_strategy("kakurenbo", **kw)


def rows(base: dict, kk: dict) -> list[str]:
    """The CSV rows of ``run_figure``'s results, one per epoch."""
    out = []
    for h, bt in zip(kk["history"], [b.wall_time for b in base["history"]]):
        speedup = bt / h.wall_time if h.wall_time else float("nan")
        out.append(table2.csv_row(f"fig4/epoch{h.epoch}", h.wall_time * 1e6,
                                  f"hidden_fraction={h.hidden_fraction:.3f};"
                                  f"epoch_speedup={speedup:.3f}"))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    ap.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = ap.parse_args(argv)
    for line in rows(*run_figure(n=args.n, n_test=args.n_test,
                                 epochs=args.epochs, device=args.device)):
        print(line, flush=True)


if __name__ == "__main__":
    main()
