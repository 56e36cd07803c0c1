"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --out calib.jsonl

For every seed, one process sets the program up as a run does, runs the
window's first epoch and reads every number of the cell's checks against
the plain reference: sound runs, whose largest reading is a limit's lower
end.  For each control seed it also reads, on the same inputs and at the
cell's own sizes, with the reference in the program's place:

- the control: the reference in the precision below the configuration's
  float32 (TF32 matrix products); the plan ranked by bfloat16 losses;
- planted faults: each step's mean over half of its rows; a label of
  every row altered, in the train steps and in the refresh; with a plan,
  the epoch at the LR without its Eq. 8 factor;

whose smallest reading is a limit's upper end.  A step that leaves the
state unchanged reads ``change_gap`` = 1 by its definition and needs no
run.  ``--witness`` reads instead how far the program, the float32
reference and the control each lie from a float64 reference, at the
published or (mamba2) a zero ``dt_bias``.  One JSON line a seed and
kind.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from h100_bench import cells, check, weights  # noqa: E402
from h100_bench.session import Session  # noqa: E402

FAULTS = ("half_batch", "token", "lr_unscaled")


def readings(cell, seed: int, control: bool, device: str = "cuda") -> list:
    """The readings of one seed: ``sound`` (the program against the
    reference), and with ``control`` the control's and each planted
    fault's."""
    t0 = time.perf_counter()
    sess = Session(cell, seed, device)
    setup_s = time.perf_counter() - t0
    sess.run_window(0)
    out = sess.outputs()
    corpus = sess.corpus
    sess.close()
    t1 = time.perf_counter()
    exact = check.reference_readout(cell, seed, corpus, out, device)
    check_s = time.perf_counter() - t1
    rows = [{"seed": seed, "kind": "sound",
             "numbers": check.judge(cell, out, exact), "setup_s": setup_s,
             "check_s": check_s, "epoch": out["epoch"]["epoch"],
             "losses": check.program_readout(out)["losses"],
             "reference_losses": exact["losses"]}]
    if not control:
        return rows
    checks = cell.traffic["checks"]
    kinds = {"control": {"tf32": True}}
    kinds.update((f"fault_{f}", {"fault": f}) for f in FAULTS
                 if f != "lr_unscaled" or "plan" in checks)
    for kind, kw in kinds.items():
        got = check.numbers(check.reference_readout(cell, seed, corpus, out,
                                                    device, **kw), exact)
        if kind == "control" and "plan" in checks:
            got.update(check.plan_numbers(out["epoch"], out["state"],
                                          cell.traffic["kakurenbo"],
                                          key_dtype=torch.bfloat16))
        rows.append({"seed": seed, "kind": kind, "numbers": got})
    return rows


@contextlib.contextmanager
def zero_dt_bias():
    """Every run's weights with a zero ``dt_bias`` (the port's own init),
    the program's and the reference's alike."""
    make = weights.make

    def zeroed(arch, seed, device):
        flat = make(arch, seed, device)
        for k, v in flat.items():
            if k.endswith("ssm.dt_bias"):
                v.zero_()
        return flat
    weights.make = zeroed
    try:
        yield
    finally:
        weights.make = make


def witness(cell, seed: int, zero_dt: bool, device: str = "cuda") -> list:
    """The program, the float32 reference and the TF32 control, each
    against a float64 reference over the check's two stretches, with
    ``zero_dt`` at a zero ``dt_bias``: which side departs where a run
    reads far from the float32 reference."""
    with zero_dt_bias() if zero_dt else contextlib.nullcontext():
        sess = Session(cell, seed, device)
        sess.run_window(0)
        out = sess.outputs()
        corpus = sess.corpus
        sess.close()
        read = {"reference64": {"dtype": torch.float64},
                "reference32": {}, "control": {"tf32": True}}
        read = {k: check.reference_readout(cell, seed, corpus, out, device,
                                           **kw) for k, kw in read.items()}
    sides = {"program": check.program_readout(out),
             "reference32": read["reference32"], "control": read["control"]}
    return [{"seed": seed, "kind": f"witness_{name}", "zero_dt": zero_dt,
             "numbers": check.numbers(side, read["reference64"]),
             "losses": side["losses"],
             "reference64_losses": read["reference64"]["losses"]}
            for name, side in sides.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness", choices=("published", "zero_dt"),
                   help="the float64 witness instead, at the published or "
                        "a zero dt_bias")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for s in (int(s) for s in args.seeds.split(",")):
            got = (witness(cell, s, args.witness == "zero_dt")
                   if args.witness else readings(cell, s, s in control))
            for row in got:
                row["workload"] = cell.name
                line = json.dumps(row)
                print(line, flush=True)
                f.write(line + "\n")
                f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
