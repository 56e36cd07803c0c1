"""In-step numeric guards: detect and contain non-finite loss and grads.

Port of ``repro/train/guard.py``.  KAKURENBO's hiding decisions rest on
each sample's loss history (paper Sec. 3.4), so a numeric fault is a
selection fault: one NaN loss scattered into ``SampleState`` reads as
infinitely important and stretches the plan's thresholds.  The guard runs
inside ``Trainer.train_step``, under both epoch engines (captured into the
scanned engine's CUDA graphs on the card), and never waits on the host:

- **detection**: ``all_finite`` folds the step loss and every gradient
  into one device flag (one multi-tensor launch on the card);
- **containment** (``guard_policy="skip_update"``): ``HeldState`` keeps the
  parameters and the optimizer's state (and the error-feedback residual of
  gradient compression) at their pre-step values, bit for bit, when the
  flag says non-finite (``select``: ``torch.where`` never propagates the
  discarded branch's NaNs); with compression on, ``zero_if`` zeroes the
  gradients first, so that a poisoned gradient never enters the residual;
- **score quarantine**: observations with a non-finite loss or confidence
  (``observation_valid``) scatter the sample's previous values back
  (``core/state.py::scatter_observations(valid=)``), so the next plan is
  finite;
- **accounting**: ``GuardState``'s three int32 device counters, updated in
  place (a captured graph holds their addresses), come back in the epoch's
  one fetch; the trainer diffs them into per-epoch stats and applies
  ``guard_abort_after`` at the epoch boundary (``NonFiniteError``).

With ``guard_policy="off"`` none of this runs: the step launches exactly
the kernels of the unguarded trainer.
"""
from __future__ import annotations

import dataclasses

import torch

#: Valid ``TrainConfig.guard_policy`` values.
GUARD_POLICIES = ("off", "skip_update")


class NonFiniteError(RuntimeError):
    """``guard_abort_after`` consecutive train steps were non-finite.  A
    ``RuntimeError`` on purpose: the supervisor
    (``train/fault.py::run_with_restarts``) classifies it restartable."""


@dataclasses.dataclass
class GuardState:
    """The guard's 0-dim int32 device counters: non-finite steps, the
    current run of consecutive ones (the abort trigger), and quarantined
    observations.  All cumulative over the run; never checkpointed (run
    diagnostics, not trajectory)."""

    nonfinite_steps: torch.Tensor
    consecutive: torch.Tensor
    quarantined: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [self.nonfinite_steps, self.consecutive, self.quarantined]


def init_guard_state(device: torch.device | str) -> GuardState:
    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)
    return GuardState(zero(), zero(), zero())


def all_finite(scalar: torch.Tensor, grads: list[torch.Tensor],
               found: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
    """0-dim bool: the step loss and every gradient are finite.

    ``found`` is a (1,) float32 scratch tensor and ``one`` a (1,) float32
    1.0: ``_amp_foreach_non_finite_check_and_unscale_`` with an inverse
    scale of 1.0 checks every tensor in one multi-tensor launch on the card
    and leaves the values exact (x * 1.0 == x, NaN and -0.0 included); one
    call per dtype, as the op takes one dtype.
    """
    found.zero_()
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in (scalar.detach().reshape(1), *grads):
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, one)
    return (found == 0).reshape(())


@torch.no_grad()
def zero_if(bad: torch.Tensor, grads: list[torch.Tensor]) -> list[torch.Tensor]:
    """Zero every gradient, in place, when ``bad`` (a 0-dim device bool):
    applied before error-feedback compression, so that a poisoned gradient
    never enters the residual (NaNs included: a fill, not a product)."""
    for g in grads:
        g.masked_fill_(bad, 0.0)
    return grads


def select(ok: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``ok`` else ``old``, written into ``new``."""
    return torch.where(ok, new, old, out=new)


class HeldState:
    """The pre-step copy of a fixed list of tensors (parameters and optimizer
    state), restored bit for bit where a step was non-finite.

    The tensors are grouped by dtype; each group with more than one tensor
    is held in one flat buffer, so ``save`` is one multi-tensor copy and
    ``restore`` a copy out, one ``where`` and a copy back, whatever the
    number of tensors (a per-tensor ``where`` is a launch each).  The
    buffers live as long as the trainer: a captured step holds them.
    """

    def __init__(self, tensors: list[torch.Tensor]):
        self.groups = []
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.empty(sum(t.numel() for t in group),
                               dtype=group[0].dtype, device=group[0].device)
            scratch = torch.empty_like(flat)
            self.groups.append((group, flat, scratch, _views(flat, group),
                                _views(scratch, group)))

    @torch.no_grad()
    def save(self) -> None:
        for group, flat, _, held, _ in self.groups:
            if len(group) == 1:
                flat.copy_(group[0].reshape(-1))
            else:
                torch._foreach_copy_(held, group)

    @torch.no_grad()
    def restore(self, ok: torch.Tensor) -> None:
        """Each tensor back to its saved value unless ``ok``."""
        for group, flat, scratch, held, new in self.groups:
            if len(group) == 1:
                t = group[0]
                select(ok, t, flat.view(t.shape))
                continue
            torch._foreach_copy_(new, group)
            select(ok, scratch, flat)
            torch._foreach_copy_(group, new)


def _views(flat: torch.Tensor, group: list[torch.Tensor]) -> list[torch.Tensor]:
    out, start = [], 0
    for t in group:
        out.append(flat[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


def observation_valid(loss: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """(B,) mask of the observations safe to scatter: finite loss and
    finite confidence.  ``x * 0`` is (signed) zero where ``x`` is finite and
    NaN where it is not, so one sum of the two products tests both in four
    elementwise launches; ``torch.isfinite`` takes four on the card alone."""
    return loss * 0 + pc * 0 == 0


@torch.no_grad()
def update_counters(gstate: GuardState, ok: torch.Tensor,
                    quarantined: torch.Tensor | None) -> GuardState:
    """Advance the counters for one step, in place."""
    bad = (~ok).to(torch.int32)
    gstate.nonfinite_steps.add_(bad)
    gstate.consecutive.mul_(bad).add_(bad)
    if quarantined is not None:
        gstate.quarantined.add_(quarantined)
    return gstate
