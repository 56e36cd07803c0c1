"""The control on the card: the reference in TF32 in the program's place,
and the plan ranked by bfloat16 losses, at the cell's own sizes, fails at
least one of the cell's limits, and so does each planted fault (the
readings ``calibrate.py`` takes on three seeds and more)."""
import pytest

from h100_bench import calibrate, cells


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["mamba2-130m.kakurenbo"])
def test_control_fails_a_limit(cuda, workload):
    cell = cells.load(workload)
    rows = calibrate.readings(cell, 2**40 + 31, True, device="cuda")
    by_kind = {r["kind"]: r["numbers"] for r in rows}
    assert all(by_kind["sound"][k] <= v for k, v in cell.limits.items())
    assert {"control", "fault_half_batch", "fault_token",
            "fault_lr_unscaled"} <= set(by_kind)
    for kind, got in by_kind.items():
        if kind != "sound":
            assert any(got[k] > v for k, v in cell.limits.items()
                       if k in got), kind
