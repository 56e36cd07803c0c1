"""Paper reproduction driver on the PyTorch port: Tables 2/3/5/6 and
Figs. 2/4 in one run.

    python examples/torch_paper_reproduction.py [--quick]
    python examples/torch_paper_reproduction.py --quick --device cpu --n 128 --epochs 2
    python examples/torch_paper_reproduction.py --list-strategies

The counterpart of ``examples/paper_reproduction.py``.  It delegates to the
port's section modules (``repro_torch.experiments.{table2,table3,table5,
table6,fig2,fig4}``, one per table or figure), each run with ``--device``,
``--n``, ``--n-test`` and ``--epochs`` as given here (the Table 2 harness's
sizes by default, on CUDA), and writes their CSV rows to ``--out``.
``--quick`` runs Table 2 and Fig. 4 only.  The reference's last section,
``selection`` (the plan's overhead, ``benchmarks/selection_overhead.py``),
is not run here: it belongs to the port's timing harness, still to come.
Every table row is a registered ``SampleStrategy`` name;
``--list-strategies`` prints the registry.
"""
import argparse
import contextlib
import io
import os
import sys

# Allow `python examples/torch_paper_reproduction.py` from the repo root:
# the interpreter puts examples/ on sys.path, not src/ that holds
# repro_torch/.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "src"))

from repro_torch.core import STRATEGIES, available_strategies, make_strategy
from repro_torch.experiments import fig2, fig4, table2, table3, table5, table6

QUICK = (table2, fig4)
SECTIONS = (table2, table3, table5, table6, fig2, fig4)


def list_strategies(device=None) -> None:
    for name in available_strategies():
        cls = STRATEGIES[name]
        cfg = cls.config_cls.__name__ if cls.config_cls else "-"
        # Smoke-build each one so the listing doubles as a registry check.
        make_strategy(name, 8, seed=0, device=device)
        print(f"{name:>10}  {cls.__name__:<20} config={cfg}")


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="only Table 2 + Fig. 4 (fast)")
    p.add_argument("--list-strategies", action="store_true",
                   help="print the sample-strategy registry and exit")
    p.add_argument("--out", default="results/torch_paper_reproduction.csv")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    p.add_argument("--n", type=int, default=table2.NUM_SAMPLES)
    p.add_argument("--n-test", type=int, default=table2.NUM_TEST)
    p.add_argument("--epochs", type=int, default=table2.EPOCHS)
    args = p.parse_args(argv)
    if args.list_strategies:
        list_strategies(args.device)
        return
    section_argv = ["--n", str(args.n), "--n-test", str(args.n_test),
                    "--epochs", str(args.epochs)]
    if args.device is not None:
        section_argv += ["--device", args.device]
    buf = io.StringIO()
    print("name,us_per_call,derived")
    buf.write("name,us_per_call,derived\n")
    for mod in QUICK if args.quick else SECTIONS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.main(section_argv)
        text = out.getvalue()
        print(text, end="")
        buf.write(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(buf.getvalue())
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
