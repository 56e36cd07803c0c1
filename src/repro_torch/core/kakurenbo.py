"""KAKURENBO epoch orchestration (paper Fig. 1).

Port of ``repro/core/kakurenbo.py``.  Per epoch e:

  B.1/B.2  rank samples by lagging loss, hide the lowest-loss fraction <= F_e
  B.3      move back candidates not (correct & PC >= tau) when last seen
  C        train on the visible set, uniform without replacement; LR times
           1/(1-F*_e) (Eq. 8); per-sample (loss, PA, PC) recorded from the
           training forward pass ("lagging loss")
  D        forward-only refresh of the hidden set at epoch end

The whole plan — selection, move-back and the visible-first order — is one
device step (``_plan_step``); ``SampleState`` crosses to the host once per
epoch, when ``begin_epoch`` materialises the ``EpochPlan``.

``jax.random.permutation`` (threefry) has no PyTorch counterpart, so
``_plan_step`` takes the epoch's permutation as an input.  The sampler draws
it with ``torch.randperm`` from a ``torch.Generator`` on the device
(``draw_permutation``); tests replace that method to inject the reference's
permutations.

Under a data-parallel group (``ctx``, ``dist/sharding.py``) the state is
row-sharded over the ranks, as in the reference: each rank's sampler holds
its rows, its fused observe scatters the batch's gathered observations
into them (``scatter_observations(offset=)``), the plan selects over them
(``select_hidden(ctx=)``: the histogram methods' cross-shard plan, or the
gathered state under ``"sort"``) and gathers the hidden mask for the
visible-first order.  Every rank's generator is seeded alike, so the
permutation, and with it the plan, is the same on every rank.  A
checkpoint holds the whole state (``state_dict`` gathers it, and
``load_state_dict`` takes this rank's rows).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.core import planops
from repro_torch.core import selection as sel
from repro_torch.core.schedule import FractionSchedule, kakurenbo_lr
from repro_torch.core.state import (RowLayout, SampleState,
                                    scatter_observations)
from repro_torch.core.strategy import EpochPlan, SampleStrategy, register_strategy
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.kernels.backend import resolve_device
from repro_torch.kernels.threshold_select import device_scalar


@dataclasses.dataclass
class KakurenboConfig:
    max_fraction: float = 0.3
    fraction_alphas: tuple[float, ...] = (1.0, 0.8, 0.6, 0.4)
    fraction_milestones: tuple[int, ...] = (0, 30, 60, 80)
    tau: float = 0.7
    # "sort" (paper) | "histogram" (plain) | "histogram_pallas" (kernels)
    selection: str = "sort"
    drop_top_fraction: float = 0.0  # DropTop (App. D)
    adjust_lr: bool = True          # LR component (Eq. 8)
    moveback: bool = True           # MB component
    reduce_fraction: bool = True    # RF component


def _plan_step(state: SampleState, perm: torch.Tensor, f_max: float, *,
               method: str, tau: float, drop_top: float, moveback: bool,
               adjust_lr: bool, ctx: ParallelCtx | None = None):
    """The whole epoch plan on the state's device.

    Returns (hidden mask, moved-back mask, ``perm`` reordered with the
    visible set first, hidden count, F*, Eq. 8 LR factor), all tensors.
    Under a group (``ctx``) ``state`` and the hidden mask are this rank's
    rows, the rest is over every rank's samples (the same on each).
    """
    dev = state.loss.device
    f_max = device_scalar(f_max, torch.float32, dev)
    hidden = sel.select_hidden(state, f_max, method=method, tau=tau,
                               drop_top_fraction=drop_top, moveback=moveback,
                               ctx=ctx)
    # Move-back set (Sec. 3.1): hidden last epoch, visible again this epoch.
    moved_back = state.hidden & ~hidden
    hidden_all = hidden
    if ctx is not None and ctx.group is not None:
        both = ctx.gather_rows(torch.stack([hidden, moved_back], dim=1))
        hidden_all, moved_back = both[:, 0], both[:, 1]
    order, num_hidden = planops.masked_order(perm.to(dev), hidden_all)
    # The reference's ``num_hidden / n`` compiles (XLA) to a product with the
    # float32 reciprocal of the constant n, which is not always the
    # correctly rounded quotient; multiply the same way to match it.
    inv_n = torch.reciprocal(device_scalar(float(hidden_all.shape[0]),
                                           torch.float32, dev))
    f_star = num_hidden.to(torch.float32) * inv_n
    one = torch.ones((), dtype=torch.float32, device=dev)
    lr_scale = kakurenbo_lr(one, f_star) if adjust_lr else one
    return hidden, moved_back, order, num_hidden, f_star, lr_scale


class KakurenboSampler:
    """Owns the SampleState and the epoch plan."""

    def __init__(self, num_samples: int, config: KakurenboConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        self.config = c = config or KakurenboConfig()
        self.device = resolve_device(device)
        self.rows = RowLayout(num_samples, ctx)
        self.ctx = self.rows.ctx
        self.num_samples = num_samples
        self.state = self.rows.init_state(self.device)
        #: The scatter into this rank's rows (the plain one off-mesh).
        self.scatter = self.rows.scatter
        self._gen = planops.make_generator(seed, "kakurenbo", self.device)
        self._fraction_schedule = FractionSchedule(
            max_fraction=c.max_fraction,
            alphas=(c.fraction_alphas if c.reduce_fraction
                    else (1.0,) * len(c.fraction_alphas)),
            milestones=c.fraction_milestones)

    def draw_permutation(self) -> torch.Tensor:
        """This epoch's shuffle of ``range(N)``, on the device."""
        return planops.device_permutation(self._gen, self.num_samples)

    def begin_epoch(self, epoch: int) -> EpochPlan:
        c = self.config
        f_max = float(self._fraction_schedule(epoch))
        hidden, moved_back, order, num_hidden, f_star, lr_scale = _plan_step(
            self.state, self.draw_permutation(), f_max, method=c.selection,
            tau=c.tau, drop_top=c.drop_top_fraction, moveback=c.moveback,
            adjust_lr=c.adjust_lr, ctx=self.ctx)
        self.state.hidden = hidden
        # The epoch's one crossing to the host: the plan's arrays and scalars.
        order_np, mb_np = order.cpu().numpy(), moved_back.cpu().numpy()
        nh, f_star, lr_scale = int(num_hidden), float(f_star), float(lr_scale)
        n = self.num_samples
        return EpochPlan(
            epoch=epoch,
            visible_indices=order_np[: n - nh],
            hidden_indices=np.sort(order_np[n - nh:]),
            max_fraction=f_max,
            hidden_fraction=f_star,
            lr_scale=lr_scale,
            needs_refresh=nh > 0,
            host_syncs=1,
            moveback_indices=np.flatnonzero(mb_np),
        )

    def observe(self, indices: np.ndarray, loss: torch.Tensor,
                pa: torch.Tensor, pc: torch.Tensor, epoch: int) -> None:
        """Record lagging loss/PA/PC from a refresh (or training) batch."""
        self.state = self.scatter(self.state, indices, loss, pa, pc, epoch)

    def refresh_hidden(self, plan: EpochPlan,
                       eval_forward: Callable[[np.ndarray], tuple],
                       batch_size: int) -> int:
        """Forward-only pass over the hidden list (step D.1).  The trailing
        batch is padded by repeating its last index and the padding is sliced
        off before observing.  Returns the number of refreshed samples."""
        hidden = plan.hidden_indices
        for start in range(0, len(hidden), batch_size):
            idx = hidden[start : start + batch_size]
            if len(idx) < batch_size:
                pad = np.full(batch_size - len(idx), idx[-1])
                loss, pa, pc = eval_forward(np.concatenate([idx, pad]))
                loss, pa, pc = loss[: len(idx)], pa[: len(idx)], pc[: len(idx)]
            else:
                loss, pa, pc = eval_forward(idx)
            self.observe(idx, loss, pa, pc, plan.epoch)
        return int(len(hidden))

    def batches(self, plan: EpochPlan, batch_size: int) -> Iterator[np.ndarray]:
        """Full batches over the visible set; drops the trailing partial."""
        v = plan.visible_indices
        for start in range(0, len(v) - batch_size + 1, batch_size):
            yield v[start : start + batch_size]


@register_strategy("kakurenbo")
class KakurenboStrategy(SampleStrategy):
    """The paper's method behind the strategy protocol."""

    config_cls, config_field = KakurenboConfig, "kakurenbo"
    fused_observe = staticmethod(scatter_observations)

    def __init__(self, num_samples: int, config: KakurenboConfig | None = None,
                 seed: int = 0, device: str | torch.device | None = None,
                 ctx: ParallelCtx | None = None):
        super().__init__(num_samples, config, seed)
        self._inner = KakurenboSampler(num_samples, config, seed, device, ctx)
        self.fused_observe = self._inner.scatter

    @property
    def state(self) -> SampleState:
        return self._inner.state

    def get_device_state(self) -> SampleState:
        return self._inner.state

    def plan(self, epoch: int) -> EpochPlan:
        return self._inner.begin_epoch(epoch)

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        self._inner.observe(indices, loss, pa, pc, epoch)

    def on_epoch_end(self, plan: EpochPlan, eval_forward, batch_size: int) -> int:
        return self._inner.refresh_hidden(plan, eval_forward, batch_size)

    def state_dict(self) -> dict:
        inner = self._inner
        return {"arrays": {"state": inner.rows.gather(inner.state),
                           "rng_key": planops.generator_state(inner._gen)},
                "host": {}}

    def load_state_dict(self, state: dict) -> None:
        self._inner.rows.load(self._inner.state, state["arrays"]["state"])
        planops.restore_generator(self._inner._gen, state, self.seed,
                                  "kakurenbo")
