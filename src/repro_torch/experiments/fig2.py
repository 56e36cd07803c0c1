"""Paper Fig. 2 on the port: time to accuracy and the work KAKURENBO saves.

The counterpart of ``benchmarks/fig2_speedup.py``: the baseline, then
KAKURENBO at the harness's setting (``table2.kakurenbo_config``: F = 0.3,
milestones (0, E/3, E/2, 3E/4)), each through the Table 2 harness
(``experiments/table2.run_strategy``: the small paper CNN on
``SyntheticClassification(1024)``, test split 512, batch 128, 16 epochs).
The target is 0.9 x the baseline's best accuracy; a run's time to it sums
its epochs' wall seconds up to the first epoch that reaches it (NaN if
none does).

    python -m repro_torch.experiments.fig2 --device cpu --n 256 --epochs 5

prints one CSV row per run, as the reference does:
``fig2/<run>,<us per epoch>,time_to_<target>acc=...s;bwd_reduction=...;
wall_reduction=...``, both reductions against the baseline.
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import table2

#: The harness's run function; a test substitutes it, as the reference's
#: section reaches ``benchmarks.common.run_strategy``.
run_strategy = table2.run_strategy


def time_to_acc(res: dict, target: float) -> float:
    """Wall seconds of ``res``'s epochs up to the first with test accuracy
    >= ``target``; NaN if no epoch reaches it."""
    t = 0.0
    for h in res["history"]:
        t += h.wall_time
        if h.test_acc >= target:
            return t
    return float("nan")


def run_figure(**kw) -> tuple[dict, dict]:
    """The baseline and KAKURENBO runs (``table2.run_strategy``'s
    keywords; KAKURENBO at ``table2.kakurenbo_config`` of the run's
    epochs, as the harness sets it)."""
    return run_strategy("baseline", **kw), run_strategy("kakurenbo", **kw)


def rows(base: dict, kk: dict, epochs: int) -> list[str]:
    """The CSV rows of ``run_figure``'s results from ``epochs``-long runs."""
    target = 0.9 * base["best_acc"]
    out = []
    for name, res in (("fig2/baseline", base), ("fig2/kakurenbo", kk)):
        tta = time_to_acc(res, target)
        out.append(table2.csv_row(
            name, res["wall_s"] / epochs * 1e6,
            f"time_to_{target:.2f}acc={tta:.1f}s;"
            f"bwd_reduction={1 - res['bwd'] / base['bwd']:.3f};"
            f"wall_reduction={1 - res['wall_s'] / base['wall_s']:.3f}"))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    ap.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = ap.parse_args(argv)
    base, kk = run_figure(n=args.n, n_test=args.n_test, epochs=args.epochs,
                          device=args.device)
    for line in rows(base, kk, args.epochs):
        print(line, flush=True)


if __name__ == "__main__":
    main()
