"""Paper Table 6 on the port: the component ablation, v1000 to v1111.

The counterpart of ``benchmarks/table6_ablation.py``: a baseline row, then
KAKURENBO with F = 0.4 and the milestones (0, 4, 6, 9) under each of the
eight settings of move-back (MB), the reduced fraction schedule (RF) and
the LR adjustment of Eq. 8 (LR); the tag ``v1<mb><rf><lr>`` writes each
as 0 or 1 (hiding, HE, is always on).  Each run goes through the Table 2
harness (``experiments/table2.run_strategy``: the small paper CNN on
``SyntheticClassification(1024)``, test split 512, batch 128, 16 epochs).
The milestones stay as the reference writes them, whatever the run's
length.

    python -m repro_torch.experiments.table6 --device cpu --n 256 --epochs 5

prints one CSV row per run, as the reference does:
``table6/baseline,<us per epoch>,best_acc=...`` then
``table6/v1<mb><rf><lr>,<us per epoch>,best_acc=...;diff=...``.
"""
from __future__ import annotations

import argparse
import itertools

from repro_torch.core import KakurenboConfig
from repro_torch.experiments import table2

#: (tag, moveback, reduce_fraction, adjust_lr), v1000 first.
VARIANTS = tuple((f"v1{int(mb)}{int(rf)}{int(lr)}", mb, rf, lr)
                 for mb, rf, lr in itertools.product((False, True), repeat=3))
#: The harness's run function; a test substitutes it, as the reference's
#: section reaches ``benchmarks.common.run_strategy``.
run_strategy = table2.run_strategy


def config(moveback: bool, reduce_fraction: bool,
           adjust_lr: bool) -> KakurenboConfig:
    return KakurenboConfig(max_fraction=0.4, moveback=moveback,
                           reduce_fraction=reduce_fraction,
                           adjust_lr=adjust_lr,
                           fraction_milestones=(0, 4, 6, 9))


def run_table(**kw) -> tuple[dict, list[tuple[str, dict]]]:
    """The baseline, then one KAKURENBO run per variant
    (``table2.run_strategy``'s keywords)."""
    base = run_strategy("baseline", **kw)
    return base, [(tag, run_strategy("kakurenbo",
                                     kakurenbo=config(mb, rf, lr), **kw))
                  for tag, mb, rf, lr in VARIANTS]


def rows(base: dict, variants: list[tuple[str, dict]],
         epochs: int) -> list[str]:
    """The CSV rows of ``run_table``'s results from ``epochs``-long runs."""
    out = [table2.csv_row("table6/baseline", base["wall_s"] / epochs * 1e6,
                          f"best_acc={base['best_acc']:.4f}")]
    for tag, res in variants:
        out.append(table2.csv_row(
            f"table6/{tag}", res["wall_s"] / epochs * 1e6,
            f"best_acc={res['best_acc']:.4f};"
            f"diff={res['best_acc'] - base['best_acc']:+.4f}"))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    ap.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = ap.parse_args(argv)
    base, variants = run_table(n=args.n, n_test=args.n_test,
                               epochs=args.epochs, device=args.device)
    for line in rows(base, variants, args.epochs):
        print(line, flush=True)


if __name__ == "__main__":
    main()
