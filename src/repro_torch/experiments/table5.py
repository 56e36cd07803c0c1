"""Paper Table 5 on the port: the prediction-confidence threshold tau.

The counterpart of ``benchmarks/table5_tau.py``: KAKURENBO at tau = 0.5,
0.7 and 0.9 with F = 0.3 and the milestones (0, 4, 6, 9), each run through
the Table 2 harness (``experiments/table2.run_strategy``: the small paper
CNN on ``SyntheticClassification(1024)``, test split 512, batch 128, 16
epochs).  The milestones stay as the reference writes them, whatever the
run's length: a run of fewer than 10 epochs never reaches the last ones.

    python -m repro_torch.experiments.table5 --device cpu --n 256 --epochs 5

prints one CSV row per tau, as the reference does:
``table5/tau=<tau>,<us per epoch>,best_acc=...;mean_hidden=...``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import KakurenboConfig
from repro_torch.experiments import table2

TAUS = (0.5, 0.7, 0.9)
#: The harness's run function; a test substitutes it, as the reference's
#: section reaches ``benchmarks.common.run_strategy``.
run_strategy = table2.run_strategy


def config(tau: float) -> KakurenboConfig:
    return KakurenboConfig(max_fraction=0.3, tau=tau,
                           fraction_milestones=(0, 4, 6, 9))


def run_table(**kw) -> list[tuple[float, dict]]:
    """One KAKURENBO run per tau (``table2.run_strategy``'s keywords)."""
    return [(tau, run_strategy("kakurenbo", kakurenbo=config(tau), **kw))
            for tau in TAUS]


def rows(results: list[tuple[float, dict]], epochs: int) -> list[str]:
    """The CSV rows of ``run_table``'s results from ``epochs``-long runs."""
    out = []
    for tau, res in results:
        mean_hidden = sum(h.hidden_fraction for h in res["history"]) / epochs
        out.append(table2.csv_row(f"table5/tau={tau}",
                                  res["wall_s"] / epochs * 1e6,
                                  f"best_acc={res['best_acc']:.4f};"
                                  f"mean_hidden={mean_hidden:.3f}"))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    ap.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = ap.parse_args(argv)
    results = run_table(n=args.n, n_test=args.n_test, epochs=args.epochs,
                        device=args.device)
    for line in rows(results, args.epochs):
        print(line, flush=True)


if __name__ == "__main__":
    main()
