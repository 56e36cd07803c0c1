"""Mixture-of-Experts FFN: top-k routing into per-expert capacity buffers,
batched expert products and a weighted combine.

Port of ``repro/models/moe.py``: ``moe_param_defs`` in both of the
reference's layouts (their logical axes give the spec trees) and
``moe_ffn``'s local path (``_route_local`` with ``e0 = 0`` and ``e_loc =
E``, no collectives).  Under a mesh without a model axis (or ``tp_size``
1) each data rank routes its own tokens, as the reference's ``shard_map``
does per data shard (the capacity from the local T), on the layer's
gathered weights; ``models/model.py`` averages the aux term over the data
ranks.  The expert-parallel path over ``"model"`` and the ``"partial"``
forward are ROADMAP A.9(c): the model axis refuses an MoE.  Per token, as
the reference:

- the router's logits ``x @ router``, a float32 softmax, the ``top_k``
  experts and their probabilities renormalised to sum to one;
- the Switch load-balancing term ``E * sum_e f_e * p_e`` (``f_e`` the
  share of choices routed to expert e, ``p_e`` its mean probability);
- a capacity of ``cap = round_up(int(capacity_factor * k * T / E) + 1, 8)``
  slots an expert (a Python int: one shape for a given T, so a captured
  step keeps its shapes), positions by a stable sort of the choices by
  expert, and the choices past ``cap`` dropped;
- the kept choices copied into an (E * cap + 1, d) buffer, the last row the
  overflow slot, three batched products (``silu(x W_gate) * x W_up`` into
  ``W_down``: the reference's plain einsums, ``torch.bmm`` here), and each
  token's kept outputs gathered back and weighted by its probabilities.

Equal integers and a fixed order of every sum: ``torch.topk`` promises no
order among equal probabilities, ``jax.lax.top_k`` takes the lower expert
first, and so does the stable descending sort used here.  The dispatch is an
``index_copy`` into rows no two kept choices share (only the dropped
overflow row is written more than once), and the combine gathers each
kept slot once and reads slot 0 for the dropped choices, masked to zero: so
the backward's scatters sum only exact zeros into a shared row, and the
step is bit-identical from run to run (the scanned engine's and restart's
contract).  Nothing is read back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig, round_up
from repro_torch.models.common import ParamDef


def moe_param_defs(d_model: int, moe: MoEConfig,
                   mode: str = "gather") -> dict:
    """Experts stacked on a leading (E, ...) axis, sharded over ``"exp"``;
    ``mode`` is the reference's FSDP layout: ``"gather"`` shards d_model
    (ZeRO-3, gathered per layer), ``"partial"`` shards d_ff (its forward
    under a model axis is ROADMAP A.9(c): the same shapes either way)."""
    e, ff = moe.num_experts, moe.d_ff_expert
    if mode == "partial":
        return {
            "router": ParamDef((d_model, e), (None, None), scale=0.02),
            "w_gate": ParamDef((e, d_model, ff), ("exp", None, "fsdp")),
            "w_up": ParamDef((e, d_model, ff), ("exp", None, "fsdp")),
            "w_down": ParamDef((e, ff, d_model), ("exp", "fsdp", None)),
        }
    return {
        "router": ParamDef((d_model, e), (None, None), scale=0.02),
        "w_gate": ParamDef((e, d_model, ff), ("exp", "fsdp", None)),
        "w_up": ParamDef((e, d_model, ff), ("exp", "fsdp", None)),
        "w_down": ParamDef((e, ff, d_model), ("exp", None, "fsdp")),
    }


def capacity(moe: MoEConfig, tokens: int) -> int:
    """Slots an expert for ``tokens`` tokens (the reference's formula)."""
    return round_up(
        int(moe.capacity_factor * moe.top_k * tokens / moe.num_experts) + 1, 8)


class Routing(NamedTuple):
    """Where each of the T * k choices goes: choice ``i * k + j`` is token
    i's j-th expert."""
    top_p: torch.Tensor   # (T, k) float32, renormalised
    top_e: torch.Tensor   # (T, k) int64, descending probability
    pos: torch.Tensor     # (T * k,) int64, place in the expert's queue
    keep: torch.Tensor    # (T * k,) bool, pos < cap
    dst: torch.Tensor     # (T * k,) int64, e * cap + pos, or E * cap (dropped)
    cap: int
    aux: torch.Tensor     # () float32, the load-balancing term


def route(p: dict, xf: torch.Tensor, moe: MoEConfig) -> Routing:
    """Route the rows of ``xf`` (T, d)."""
    t = xf.shape[0]
    e, k = moe.num_experts, moe.top_k
    dev = xf.device
    logits = xf @ p["router"].to(xf.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(-1)
    # Choices per expert, an exact count in float32 whatever the order.
    counts = torch.zeros(e, device=dev).scatter_add_(
        0, flat_e, torch.ones(t * k, device=dev))
    aux = e * (counts / t * probs.mean(dim=0)).sum()

    cap = capacity(moe, t)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    dst = torch.where(keep, flat_e * cap + pos, e * cap)
    return Routing(top_p, top_e, pos, keep, dst, cap, aux)


def moe_ffn(p: dict, x: torch.Tensor,
            moe: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN of x (B, S, d).  Returns (y (B, S, d), the aux term)."""
    b, s, d = x.shape
    t, e, k = b * s, moe.num_experts, moe.top_k
    dt = x.dtype
    xf = x.reshape(t, d)
    r = route(p, xf, moe)
    cap = r.cap

    # Dispatch: choice i * k + j reads token i (an expand, whose backward
    # sums the k rows in a fixed order).
    src = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros(e * cap + 1, d).index_copy(0, r.dst, src)
    buf = buf[:e * cap].reshape(e, cap, d)

    h = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    out = torch.bmm(F.silu(h) * u, p["w_down"].to(dt))

    # Combine: each kept slot is read once; dropped choices read slot 0,
    # zeroed.
    lidx = torch.where(r.keep, r.dst, 0)
    vals = out.reshape(e * cap, d).index_select(0, lidx)
    vals = torch.where(r.keep[:, None], vals, 0.0)
    y = (vals.reshape(t, k, d) * r.top_p[..., None].to(dt)).sum(dim=1)
    return y.reshape(b, s, d), r.aux
