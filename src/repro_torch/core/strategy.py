"""Sample-selection strategy protocol and registry.

Port of ``repro/core/strategy.py`` (the registry is this package's own: the
port registers only the strategies it has ported).  The per-epoch contract
driven by ``train/trainer.py``:

0. ``prepare(epoch, feats_fn)`` — host work before the plan (Grad-Match's
   reselection from the features ``feats_fn()`` yields);
1. ``plan(epoch) -> EpochPlan`` — the visible index list, LR scaling, the
   hidden list and the flags (``needs_refresh`` for KAKURENBO's step D,
   ``reinit_model`` for FORGET's restart after warmup);
2. per batch: ``batch_weights(indices)`` (static per-sample loss weights,
   a plan-time lookup: ISWR, InfoBatch) and the in-step hooks on the
   strategy's device state (``get_device_state``/``set_device_state``):
   ``fused_select`` before the backward pass (Selective-Backprop's
   loss-dependent mask) and ``fused_observe`` after it (the bookkeeping
   scatter);
3. ``observe(indices, loss, pa, pc, epoch)`` — lagging-loss bookkeeping
   outside the train step (the step-D refresh);
4. ``on_epoch_end(plan, eval_forward, batch_size) -> int`` — end-of-epoch
   work (the hidden-list refresh); returns extra forward samples;
5. ``state_dict()`` / ``load_state_dict(sd)`` — checkpoint and restore,
   ``{"arrays": ..., "host": ...}`` as in the reference.

The scanned engine captures the train step in CUDA graphs, which hold the
addresses of everything the step touches.  So the in-step hooks update the
strategy's device state in place, ``step_tensors`` names the tensors they
touch (the engine checks before every replay that they are still the
strategy's), the hooks draw no numbers from a ``torch.Generator`` (a graph
would replay the captured draws; SB's draws are counter-based state), and
``load_state_dict`` and ``set_device_state`` copy into the existing
tensors, never rebind them.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import copy_into, flatten
from repro_torch.core.state import OBSERVED_FIELDS, SampleState


@dataclasses.dataclass
class EpochPlan:
    """One epoch's sampling decision; index arrays are host numpy arrays of
    global sample ids, materialised once per epoch (``host_syncs``)."""

    epoch: int
    visible_indices: np.ndarray            # shuffled training index list
    hidden_indices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))
    max_fraction: float = 0.0              # F_e (ceiling)
    hidden_fraction: float = 0.0           # F*_e (actual, after move-back)
    lr_scale: float = 1.0                  # Eq. 8 factor (1.0 = off)
    needs_refresh: bool = False            # run step-D refresh at epoch end
    reinit_model: bool = False             # restart the model (FORGET)
    host_syncs: int = 0                    # device->host syncs spent planning
    #: Samples hidden last epoch that move-back returned to training.
    moveback_indices: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))


EvalForward = Callable[[np.ndarray], tuple]   # indices -> (loss, pa, pc)
#: () -> host (features (N, d), labels (N,)), computed only when called.
FeatsFn = Callable[[], tuple[np.ndarray, np.ndarray]]


class SampleStrategy:
    """Base class (and protocol) of the sample-selection strategies."""

    name: str = "?"                        # filled in by @register_strategy
    config_cls: type | None = None         # dataclass type of the config
    config_field: str | None = None        # attr name on a composite config

    #: ``(state, indices, loss, pa, pc, epoch, valid=None) -> state``, run
    #: by the trainer after every train step on the strategy's device state;
    #: ``valid`` is the numeric guard's quarantine mask
    #: (``state.scatter_observations``).
    fused_observe: Callable | None = None

    #: ``(state, loss) -> (weights, state)``, run by the trainer before the
    #: backward pass on the (B,) f32 loss of a forward-only pass at the
    #: current weights.  The (B,) f32 ``weights`` multiply the per-sample
    #: losses of the objective; 0 drops a sample from the backward pass and
    #: from ``bwd_samples``.
    fused_select: Callable | None = None

    def __init__(self, num_samples: int, config: Any = None, seed: int = 0):
        self.num_samples = num_samples
        self.config = config
        self.seed = seed

    def prepare(self, epoch: int, feats_fn: FeatsFn | None = None) -> None:
        """Host hook before ``plan`` every epoch.  ``feats_fn`` yields the
        host ``(features, labels)`` lazily: only Grad-Match calls it."""

    def plan(self, epoch: int) -> EpochPlan:
        raise NotImplementedError

    def observe(self, indices, loss, pa, pc, epoch: int) -> None:
        """Record lagging (loss, PA, PC) outside the train step."""

    @property
    def supports_scan(self) -> bool:
        """Can an epoch run as captured multi-step blocks (the scanned
        engine) with no host work between steps?  True unless the strategy
        observes on the host without a ``fused_observe``; ``batch_weights``
        is a plan-time lookup, pre-gathered into the epoch plan."""
        observes = type(self).observe is not SampleStrategy.observe
        return not observes or self.fused_observe is not None

    def batch_weights(self, indices: np.ndarray) -> np.ndarray | None:
        """(B,) f32 host loss weights for this batch (None = uniform),
        looked up from plan-time decisions; never touches device state."""
        return None

    def get_device_state(self):
        return None

    def set_device_state(self, state) -> None:
        """Take the state back from the trainer: the same object (the hooks
        update it in place), or another whose tensors are copied in."""
        own = self.get_device_state()
        if own is None:
            raise NotImplementedError(
                f"{type(self).__name__} declares no device-resident state")
        if state is not own:
            copy_into(own, state)

    def step_tensors(self) -> list[torch.Tensor]:
        """The device tensors the in-step hooks read or write: what a
        captured train step holds by address (a ``SampleState``'s
        ``OBSERVED_FIELDS``, not the plan's ``hidden``)."""
        state = self.get_device_state()
        if isinstance(state, SampleState):
            return [getattr(state, f) for f in OBSERVED_FIELDS]
        return [t for _, t in flatten(state)]

    def on_epoch_end(self, plan: EpochPlan, eval_forward: EvalForward,
                     batch_size: int) -> int:
        return 0

    def state_dict(self) -> dict:
        """``{"arrays": <nested dict of tensors and arrays>, "host":
        <json-able dict>}``; the arrays' structure is fixed at construction
        (it becomes checkpoint leaves) and restoring must be bit-exact."""
        return {"arrays": {}, "host": {}}

    def load_state_dict(self, state: dict) -> None:
        if state.get("arrays") or state.get("host"):
            raise ValueError(
                f"{type(self).__name__} has no state to restore into")


STRATEGIES: dict[str, type[SampleStrategy]] = {}


def register_strategy(name: str):
    """Class decorator: ``@register_strategy("kakurenbo")``."""

    def deco(cls: type[SampleStrategy]) -> type[SampleStrategy]:
        if name in STRATEGIES and STRATEGIES[name] is not cls:
            raise ValueError(f"strategy {name!r} already registered")
        cls.name = name
        STRATEGIES[name] = cls
        return cls

    return deco


def available_strategies() -> list[str]:
    import repro_torch.core  # noqa: F401  (runs the decorators)
    return sorted(STRATEGIES)


def make_strategy(name: str, num_samples: int, cfg: Any = None,
                  seed: int = 0, **extras: Any) -> SampleStrategy:
    """Build a registered strategy.  ``cfg`` is the strategy's own config
    or a composite carrying it as ``cls.config_field``; ``extras`` reach
    only constructors that declare them."""
    if name not in available_strategies():
        raise ValueError(
            f"unknown strategy {name!r}; known: {available_strategies()}")
    cls = STRATEGIES[name]
    if cls.config_cls is None:
        cfg_obj = None
    elif cfg is None or isinstance(cfg, cls.config_cls):
        cfg_obj = cfg
    else:
        cfg_obj = getattr(cfg, cls.config_field or "", None)
        if not isinstance(cfg_obj, cls.config_cls):
            raise TypeError(
                f"cfg for strategy {name!r} must be {cls.config_cls.__name__}"
                f" or carry a .{cls.config_field} of that type; got "
                f"{type(cfg).__name__}")
    params = inspect.signature(cls.__init__).parameters
    kw = {k: v for k, v in extras.items() if k in params}
    return cls(num_samples, cfg_obj, seed=seed, **kw)


# ---------------------------------------------------------------------------
# Shared helpers for strategy implementations


def rng_state(rng: np.random.Generator) -> dict:
    """A numpy generator's bit-generator state (JSON-able)."""
    return rng.bit_generator.state


def set_rng_state(rng: np.random.Generator, state: dict) -> None:
    rng.bit_generator.state = state


class inner_attr:
    """An attribute a strategy forwards to its sampler (``self._inner``),
    for reading and for setting: ``strategy.draw_uniform = f`` replaces the
    sampler's draw, which its ``begin_epoch`` calls."""

    def __init__(self, name: str | None = None):
        self.name = name

    def __set_name__(self, owner, name: str) -> None:
        self.name = self.name or name

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return getattr(obj._inner, self.name)

    def __set__(self, obj, value) -> None:
        setattr(obj._inner, self.name, value)
