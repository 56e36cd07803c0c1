"""The model's weights, made on the device from the seed.

The benchmark owns the weights: it makes them and hands the same to the
program and to the plain reference.  A leaf's name is the program's
``LM.state_dict()`` key (``embed``, ``layers.3.attn.wq``, ...).  Every
kind of leaf (a top-level leaf, or one leaf of every layer stacked as
``(L, ...)``) is one draw from a ``torch.Generator`` of its own, seeded
from the run's seed and the kind's name, so that one kind can be drawn
again alone (``draw_kind``) without the others.

Inits: matrices normal at their fan-in's scale (the input width of the
product), the embedding normal times 0.02, the SSM's conv normal times 0.5,
and Mamba-2's published ones for its decay: ``a_log`` = log U[1, 16] and
``dt_bias`` the inverse softplus of a dt drawn log-uniform in [0.001, 0.1]
(at a zero ``dt_bias`` the first steps' losses of the program and of the
float32 reference alike lie up to 1e-3 to 2e-2 from a float64
reference's, so that no float32 comparison of them holds); norms and
``d_skip`` ones, the other biases zeros.
"""
from __future__ import annotations

import math
import zlib

import torch

from h100_bench import seeds


def kinds(arch: dict) -> dict:
    """``{kind: (shape, init, scale, stacked)}`` of ``arch``; a stacked
    kind's shape leads with the layer count and its leaves are
    ``layers.<i>.<kind>``."""
    d, v, nl = arch["d_model"], arch["vocab_size"], arch["num_layers"]
    top = {"embed": ((v, d), "normal", 0.02),
           "out_norm": ((d,), "ones", None)}
    if not arch["tie_embeddings"]:
        top["lm_head"] = ((d, v), "normal", d ** -0.5)
    layer = {"ln1": ((d,), "ones", None)}
    if arch["num_heads"]:
        hq, hkv, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
        layer.update({
            "attn.wq": ((d, hq, hd), "normal", d ** -0.5),
            "attn.wk": ((d, hkv, hd), "normal", d ** -0.5),
            "attn.wv": ((d, hkv, hd), "normal", d ** -0.5),
            "attn.wo": ((hq, hd, d), "normal", (hq * hd) ** -0.5)})
        if arch["qk_norm"]:
            layer["attn.q_norm"] = ((hd,), "ones", None)
            layer["attn.k_norm"] = ((hd,), "ones", None)
        layer["ln2"] = ((d,), "ones", None)
    if arch["d_ff"]:
        ff = arch["d_ff"]
        layer.update({"mlp.w_gate": ((d, ff), "normal", d ** -0.5),
                      "mlp.w_up": ((d, ff), "normal", d ** -0.5),
                      "mlp.w_down": ((ff, d), "normal", ff ** -0.5)})
    ssm = arch.get("ssm")
    if ssm:
        di, n = ssm["expand"] * d, ssm["state_dim"]
        nh = di // ssm["head_dim"]
        layer.update({
            "ssm.w_in": ((d, 2 * di + 2 * n + nh), "normal", d ** -0.5),
            "ssm.conv_w": ((ssm["conv_width"], di + 2 * n), "normal", 0.5),
            "ssm.conv_b": ((di + 2 * n,), "zeros", None),
            "ssm.a_log": ((nh,), "a_log", None),
            "ssm.d_skip": ((nh,), "ones", None),
            "ssm.dt_bias": ((nh,), "dt_bias", None),
            "ssm.norm_w": ((di,), "ones", None),
            "ssm.w_out": ((di, d), "normal", di ** -0.5)})
    out = {k: (shape, init, scale, False) for k, (shape, init, scale)
           in top.items()}
    out.update({k: ((nl, *shape), init, scale, True) for k, (shape, init, scale)
                in layer.items()})
    return out


def draw_kind(arch: dict, seed: int, kind: str, device) -> torch.Tensor:
    """Kind ``kind``'s whole tensor (stacked kinds with the layer dim)."""
    shape, init, scale, _ = kinds(arch)[kind]
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "zeros":
        return torch.zeros(shape, device=device)
    base = seeds.int_seed(seeds.child(seed, "weights"))
    gen = torch.Generator(device=device)
    gen.manual_seed((base ^ zlib.crc32(kind.encode())) & ((1 << 62) - 1))
    if init == "a_log":
        return torch.log(torch.empty(shape, device=device).uniform_(
            1.0, 16.0, generator=gen))
    if init == "dt_bias":
        u = torch.empty(shape, device=device).uniform_(generator=gen)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001)).clamp(min=1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    return torch.randn(shape, generator=gen, device=device) * scale


def leaves(arch: dict, kind: str, whole: torch.Tensor) -> dict:
    """``{leaf name: tensor}`` of one kind (views of ``whole``)."""
    if not kinds(arch)[kind][3]:
        return {kind: whole}
    return {f"layers.{i}.{kind}": whole[i] for i in range(whole.shape[0])}


def make(arch: dict, seed: int, device) -> dict:
    """Every leaf, ``{name: tensor}`` in float32 on ``device``."""
    out = {}
    for kind in kinds(arch):
        out.update(leaves(arch, kind, draw_kind(arch, seed, kind, device)))
    return out


def nested(flat: dict) -> dict:
    """The program's parameter tree of a flat ``{name: tensor}``: nested
    dicts, ``layers`` a list of per-layer trees."""
    tree: dict = {}
    for name, t in flat.items():
        parts = name.split(".")
        node = tree
        if parts[0] == "layers":
            layers = tree.setdefault("layers", {})
            node = layers.setdefault(int(parts[1]), {})
            parts = parts[2:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    if "layers" in tree:
        tree["layers"] = [tree["layers"][i] for i in sorted(tree["layers"])]
    return tree


def leaf_norms(flat: dict) -> dict:
    """Each leaf's float64 2-norm, read in one transfer."""
    names = list(flat)
    got = torch.stack([torch.linalg.vector_norm(flat[k], dtype=torch.float64)
                       for k in names]).cpu().numpy()
    return dict(zip(names, got.tolist()))
