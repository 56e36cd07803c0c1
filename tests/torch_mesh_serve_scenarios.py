"""Scenarios of serving on the port's model axis, run in every rank of a
gloo world on the CPU (``tests/test_torch_mesh_serve.py``).

Each case builds its ``("data", "model")`` mesh
(``launch/mesh.py::make_data_model_mesh``) and context
(``launch/train.py::build_ctx``), takes this rank's shards of the given
global parameters (``Model.shard``), prefills the global batch and decodes
greedily (every rank feeds the global batch's argmax), and gathers the
cache back whole (``Model.gather_cache``).  Each rank runs PyTorch on one
thread.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.dist.sharding import ParallelCtx
from repro_torch.launch.mesh import make_data_model_mesh
from repro_torch.launch.train import build_ctx
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model


def greedy(cfg, ctx, params: dict, batch: dict, max_len: int, steps: int,
           decode_cfg=None) -> dict:
    """``Model.prefill`` of the global ``batch`` then ``steps`` greedy
    ``decode_step``s on ``ctx``'s shards of ``params`` (None: one device);
    ``decode_cfg``: the config the decode steps run under.  Returns the
    last position's logits of the prefill and of every step (steps + 1,
    B, V), the greedy tokens (B, steps) and the gathered cache, as
    numpy."""
    model = build_model(cfg, ctx, device="cpu")
    dec = model if decode_cfg is None else build_model(decode_cfg, ctx,
                                                       device="cpu")
    local = model.shard(params)
    with torch.no_grad():
        logits, cache = model.prefill(
            local, {k: torch.from_numpy(v) for k, v in batch.items()},
            max_len)
        out, toks = [logits[:, -1]], []
        for _ in range(steps):
            tok = logits[:, -1:].argmax(dim=-1)
            toks.append(tok)
            logits, cache = dec.decode_step(local, tok, cache)
            out.append(logits[:, -1])
        whole = model.gather_cache(cache)
    return {"logits": np.stack([t.numpy() for t in out]),
            "tokens": torch.cat(toks, dim=1).numpy(),
            "local_k": (tuple(cache["k"].shape) if "k" in cache else None),
            "cache": {k: (v if k == "len" else v.numpy())
                      for k, v in whole.items()}}


def serve_world(rank: int, world: int, cases: list, attend: tuple) -> dict:
    """Every ``(name, cfg, params, batch, mesh shape, build_ctx kwargs,
    max_len, steps)`` case in order (``greedy``'s record on rank 0, the
    tokens on the others), and ``attention.decode_attend_sp`` of
    ``attend`` = (q, k, v, cache_len) over the 8 ranks of a (1, 8) mesh,
    each rank its span of the sequence."""
    torch.set_num_threads(1)
    out, meshes = {}, {}
    for name, cfg, params, batch, shape, kw, max_len, steps in cases:
        if shape not in meshes:
            meshes[shape] = make_data_model_mesh(*shape)
        got = greedy(cfg, build_ctx(cfg, meshes[shape], **kw), params, batch,
                     max_len, steps)
        out[name] = got if rank == 0 else {"tokens": got["tokens"]}
    if (1, 8) not in meshes:
        meshes[(1, 8)] = make_data_model_mesh(1, 8)
    ctx = ParallelCtx(mesh=meshes[(1, 8)])
    q, k, v = (torch.from_numpy(a) for a in attend[:3])
    n = attend[3]
    s_loc = k.shape[1] // ctx.tp_size
    start = ctx.tp_rank * s_loc
    with torch.no_grad():
        out["attend_sp"] = attn.decode_attend_sp(
            q, k[:, start:start + s_loc], v[:, start:start + s_loc], n,
            start, ctx).numpy()
    return out


def unit_serve_world(rank: int, world: int, cases: list) -> dict:
    """Each ``(name, cfg, params, batch, build_ctx kwargs, max_len,
    steps)`` served on a (1, 1) mesh and without a context: whether the
    logits, the tokens and every cache entry agree bit for bit."""
    torch.set_num_threads(1)
    mesh = make_data_model_mesh(1, 1)
    out = {}
    for name, cfg, params, batch, kw, max_len, steps in cases:
        a = greedy(cfg, build_ctx(cfg, mesh, **kw), params, batch, max_len,
                   steps)
        b = greedy(cfg, None, params, batch, max_len, steps)
        out[name] = {
            "logits": np.array_equal(a["logits"], b["logits"]),
            "tokens": np.array_equal(a["tokens"], b["tokens"]),
            "cache": a["cache"].keys() == b["cache"].keys() and all(
                (a["cache"][k] == b["cache"][k]) if k == "len"
                else np.array_equal(a["cache"][k], b["cache"][k])
                for k in a["cache"])}
    return out
