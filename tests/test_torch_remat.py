"""PyTorch port, the layers' recompute policies (``models/common.py::
remat``): none, ``"nothing"`` (each layer a checkpoint of its inputs) and
``"dots"`` (the reference's ``checkpoint_dots``: the matmul outputs kept,
the rest recomputed, the collectives always).

For small dense, MoE, SSM and encoder-decoder models on the CPU, the loss
and every gradient are bit-identical under the three; by
``torch.utils.flop_counter``, ``"dots"`` runs the matmuls no remat runs,
and ``"nothing"`` with a whole recompute those plus the checkpointed
layers' forward matmuls again (the forward's, less that of the model
without layers); by default (torch's early stop) at most that.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch
import torch.utils.checkpoint as ckpt
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import get_arch
from repro_torch.dist.sharding import ParallelCtx
from repro_torch.models.common import remat
from repro_torch.models.model import build_model, family_module, loss_and_metrics

BASE = dict(num_layers=2, d_model=64, vocab_size=256)
CONFIGS = {
    "dense-d": ArchConfig(name="dense-d", family="dense", num_heads=8,
                          num_kv_heads=4, d_ff=128, head_dim=16, qk_norm=True,
                          **BASE),
    "moe-d": ArchConfig(name="moe-d", family="moe", num_heads=8,
                        num_kv_heads=4, d_ff=0, head_dim=16,
                        moe=MoEConfig(8, 2, 64, capacity_factor=8.0), **BASE),
    "ssm-d": ArchConfig(name="ssm-d", family="ssm", num_heads=0,
                        num_kv_heads=0, d_ff=0,
                        ssm=SSMConfig(16, 16, chunk=16), **BASE),
    "seamless": get_arch("seamless-m4t-large-v2").reduced(),
}
POLICIES = {"none": None, "nothing": ParallelCtx(remat=True),
            "dots": ParallelCtx(remat=True, remat_policy="dots")}
B, S = 4, 32


def _batch(cfg) -> dict:
    g = torch.Generator().manual_seed(1)
    s = S // 4 if cfg.family == "encdec" else S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, s), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (B, s), generator=g),
             "mask": torch.ones(B, s, dtype=torch.bool)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, S, cfg.encoder_input_dim,
                                      generator=g)
    return batch


def _leaves(cfg) -> tuple[dict, list]:
    model = build_model(cfg, device="cpu")
    tree = model.shard(model.init(torch.Generator().manual_seed(0)))
    leaves = [t.requires_grad_(True) for _, t in flatten(tree)]
    return tree, leaves


def _run(cfg, ctx, early_stop: bool = True):
    tree, leaves = _leaves(cfg)
    batch = _batch(cfg)
    with FlopCounterMode(display=False) as fc, \
            ckpt.set_checkpoint_early_stop(early_stop):
        loss, _ = loss_and_metrics(cfg, tree, batch, ctx)
        loss.backward()
    return (loss.item(), [t.grad.clone() for t in leaves],
            fc.get_total_flops())


def _forward_flops(cfg) -> int:
    """The forward's matmul FLOPs."""
    tree, _ = _leaves(cfg)
    batch = _batch(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        family_module(cfg).forward(cfg, tree, batch)
    return fc.get_total_flops()


def _layers_forward_flops(cfg) -> int:
    """The layers' share of the forward's: less that of the same model
    with no layers (the logits' product, the encoder's input
    projection)."""
    bare = dataclasses.replace(cfg, num_layers=0, num_encoder_layers=0)
    return _forward_flops(cfg) - _forward_flops(bare)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_policies_give_the_same_bits_and_the_flops_they_keep(arch):
    cfg = CONFIGS[arch]
    got = {name: _run(cfg, ctx) for name, ctx in POLICIES.items()}
    loss, grads, flops = got["none"]
    for name in ("nothing", "dots"):
        assert got[name][0] == loss, name
        assert all(torch.equal(a, b) for a, b in zip(got[name][1], grads)), \
            name
    assert got["dots"][2] == flops
    # A whole recompute; by default torch stops it after the last tensor
    # the backward needs (a layer's last product is not run again).
    whole = _run(cfg, POLICIES["nothing"], early_stop=False)
    assert whole[:1] == got["nothing"][:1]
    assert whole[2] == flops + _layers_forward_flops(cfg)
    assert flops < got["nothing"][2] <= whole[2]


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_kernel_functions_under_checkpoint(policy):
    """B7's and B6's autograd Functions (their card path: the kernel
    forward, the plain backward from the saved inputs) inside a layer
    checkpoint of either policy: the gradients of the Functions outside
    one, bit for bit (the saved inputs are read once a backward)."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 16, h, 16, generator=g) for h in (4, 2, 2))
    x = torch.randn(2, 16, 3, 8, generator=g)
    dt, b, c = (torch.randn(2, 16, n, generator=g) for n in (3, 8, 8))
    a_log, d = torch.rand(3, generator=g), torch.randn(3, generator=g)

    def fn(q, k, v, x):
        att = ops._FlashAttention.apply(q, k, v, True)
        y, _ = ops._SSDScan.apply(x, dt, a_log, b, c, d, 8)
        return att.square().sum() + y.square().sum()

    grads = []
    for ctx in (None, POLICIES[policy]):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, x)]
        remat(ctx, fn, *leaves).backward()
        grads.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
