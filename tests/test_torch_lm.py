"""PyTorch port, the LM's training loss and its parts against the JAX package.

- ``SyntheticLM``: byte-identical to the reference's for a seed (``get``,
  ``arrays`` through the port's ``materialize``, ``test_split``);
- ``token_metrics`` / ``per_sample_metrics`` against the reference's: ce and
  PC within 1e-6, PA exact, with masked positions and an all-masked row;
  and the one place they differ on purpose, B1's tie rule (``gold >= max``
  against the reference's ``argmax == label``), on a constructed tie;
- ``Model.loss_and_metrics`` (the scalar, with and without ``weight``, and
  the per-sample triple) and the gradient of every leaf against ``jax.grad``
  of the reference's, at 1e-5 relative (per leaf, in norm), on reduced
  smollm-135m and mamba2-130m from the reference's parameters.  Two
  conditioning controls, the same on both sides: the dense family's
  attention projections at their input's fan-in (under the reference's
  init the float32 noise of either package alone reaches 5e-5 here, ROADMAP
  C), and ``a_log`` drawn U[0, 1) as ``tests/test_kernels.py`` draws it (at
  the init's decay rates ``a_log``'s gradient cancels to 1e-4 of float32
  noise in either package);
- the autograd Functions that carry B6's and B7's gradient: with the plain
  forward (the CPU's) their gradient equals plain autograd's bit for bit,
  and a kernel wrapper refuses an input that requires grad in grad mode;
- ``LM``: one parameter per layer leaf under the reference tree's paths,
  ``params_from_jax(unstack=True)``, prefill/decode from its parameters.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro_torch.configs.base import MoEConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import loss_confidence as tlc
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import LM, build_model, transformer
from repro_torch.models.model import loss_and_metrics

DENSE, SSM = "smollm-135m", "mamba2-130m"


# ---------------------------------------------------------------------------
# SyntheticLM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order,chunk", [(1, 4096), (3, 7)])
def test_synthetic_lm_is_byte_identical(order, chunk):
    kw = dict(num_samples=24, seq_len=12, vocab_size=40, easy_fraction=0.7,
              order=order, seed=5)
    a, b = SyntheticLM(**kw), JSyntheticLM(**kw)
    assert a.table.tobytes() == b.table.tobytes()
    assert a.difficulty.tobytes() == b.difficulty.tobytes()
    idx = np.array([0, 23, 5, 5, 11])
    for x, y in ((a.get(idx), b.get(idx)),
                 (a.arrays(chunk), b.arrays(chunk)),
                 (a.test_split(9).get(idx[2:] - 3), b.test_split(9).get(idx[2:] - 3))):
        assert x.keys() == y.keys() == {"tokens", "labels", "mask"}
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            assert np.ascontiguousarray(x[k]).tobytes() == \
                np.ascontiguousarray(y[k]).tobytes(), k
    rows = a.arrays(chunk)
    assert np.array_equal(rows["tokens"][idx], a.get(idx)["tokens"])


# ---------------------------------------------------------------------------
# Sequence-level metrics
# ---------------------------------------------------------------------------


def _logits(b, s, v, seed):
    r = np.random.default_rng(seed)
    lg = (r.normal(size=(b, s, v)) * 3).astype(np.float32)
    lab = r.integers(0, v, (b, s)).astype(np.int32)
    # Some tokens right, so PA sees both sides of its threshold.
    right = r.random((b, s)) < np.linspace(0.2, 0.9, b)[:, None]
    lg[right, lab[right]] = lg[right].max(-1) + 1.0
    return lg, lab


@pytest.mark.parametrize("b,s,v", [(6, 10, 37), (3, 33, 300)])
def test_token_metrics_match_reference(b, s, v):
    lg, lab = _logits(b, s, v, seed=v)
    want = jtransformer.token_metrics(jnp.asarray(lg), jnp.asarray(lab))
    got = transformer.token_metrics(torch.from_numpy(lg), torch.from_numpy(lab))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,s,v", [(6, 10, 37), (4, 24, 257)])
def test_per_sample_metrics_match_reference(b, s, v):
    lg, lab = _logits(b, s, v, seed=s)
    mask = np.random.default_rng(s).random((b, s)) < 0.7
    mask[1] = False                      # an all-masked row divides by 1
    cfg, jcfg = get_arch(DENSE).reduced(), jget_arch(DENSE).reduced()
    want = jtransformer.per_sample_metrics(jcfg, jnp.asarray(lg),
                                           jnp.asarray(lab), jnp.asarray(mask))
    got = transformer.per_sample_metrics(cfg, torch.from_numpy(lg),
                                         torch.from_numpy(lab),
                                         torch.from_numpy(mask))
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 0 < got[1].sum() < b
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-6, atol=1e-6)
    assert got[0][1] == 0 and got[2][1] == 0 and not got[1][1]


def test_tie_rule_differs_from_argmax_only_on_a_tie():
    """B1 counts a token correct when gold >= max; the reference's
    ``argmax == label`` takes the first maximum.  With the gold logit tied
    at the maximum behind an earlier one, the two differ; untied they
    agree."""
    lg = np.zeros((1, 2, 5), np.float32)
    lg[0, 0, [1, 3]] = 2.0               # tie: index 1 first, gold 3
    lg[0, 1, 3] = 2.0                    # no tie
    lab = np.array([[3, 3]], np.int32)
    _, jc, _ = jtransformer.token_metrics(jnp.asarray(lg), jnp.asarray(lab))
    _, tc, _ = transformer.token_metrics(torch.from_numpy(lg),
                                         torch.from_numpy(lab))
    assert np.asarray(jc).tolist() == [[False, True]]
    assert tc.numpy().tolist() == [[True, True]]


# ---------------------------------------------------------------------------
# loss_and_metrics and its gradient against jax.grad
# ---------------------------------------------------------------------------


def _conditioned_reference(arch, seed=0):
    """The reference's reduced config and init, with the two conditioning
    controls of the module docstring applied (identically on both sides)."""
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.array, jm.init(jax.random.key(seed)))
    r = np.random.default_rng(seed)
    layers = jp["layers"]
    if "attn" in layers:
        a, dh = layers["attn"], cfg.resolved_head_dim
        for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                          ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
            a[name] = a[name] * np.float32((a[name].shape[-2] / fan) ** 0.5)
    if "ssm" in layers:
        layers["ssm"]["a_log"] = r.uniform(
            0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return cfg, jm, jp


def _lm_batch(cfg, b=4, s=24, seed=0):
    """A SyntheticLM batch (vocab 64 of the model's) with masked positions,
    an all-masked row and per-sample weights, as numpy."""
    ds = SyntheticLM(num_samples=b, seq_len=s, vocab_size=64, order=1,
                     easy_fraction=0.7, seed=seed)
    batch = ds.get(np.arange(b))
    r = np.random.default_rng(seed)
    batch["mask"] = r.random((b, s)) < 0.8
    batch["mask"][1] = False
    batch["weight"] = r.random(b).astype(np.float32)
    return batch


def _leaf(tree, name):
    """The reference tree's leaf for an ``LM`` parameter name: layer ``i``
    of a stacked leaf for ``layers.i.<path>``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    tree = tree["layers"]
    for k in parts[2:]:
        tree = tree[k]
    return tree[int(parts[1])]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("arch", [DENSE, SSM])
def test_loss_and_metrics_and_gradients_match_jax(arch, weighted):
    cfg, jm, jp = _conditioned_reference(arch)
    batch = _lm_batch(cfg)
    if not weighted:
        del batch["weight"]
    (js, (jl, jpa, jpc)), jg = jax.value_and_grad(
        jm.loss_and_metrics, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = LM(cfg, transformer.params_from_jax(jp, "cpu", unstack=True))
    scalar, (loss, pa, pc) = lm.loss_and_metrics(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in batch.items()})
    scalar.backward()
    np.testing.assert_allclose(scalar.item(), float(js), rtol=1e-5)
    np.testing.assert_allclose(loss.detach().numpy(), jl, rtol=1e-5, atol=1e-6)
    assert np.array_equal(pa.numpy(), np.asarray(jpa))
    np.testing.assert_allclose(pc.detach().numpy(), jpc, rtol=1e-6, atol=1e-6)
    jg = jax.tree.map(np.asarray, jg)
    names = [n for n, _ in lm.named_parameters()]
    assert len(names) == len(jax.tree.leaves(jg["layers"])) * cfg.num_layers \
        + len([k for k in jg if k != "layers"])
    for name, p in lm.named_parameters():
        want = _leaf(jg, name)
        assert p.grad is not None and p.grad.shape == want.shape, name
        rel = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (name, rel)


def test_loss_terms_of_unported_families_raise():
    """The MoE's aux term and the VLM's patch positions are ported (the
    model zoo's tests hold them to the reference); the encoder-decoder
    family is not."""
    cfg = get_arch(DENSE).reduced()
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in _lm_batch(cfg).items()}
    encdec = dataclasses.replace(cfg, family="encdec")
    with pytest.raises(NotImplementedError, match=r"A\.6\(d\)"):
        loss_and_metrics(encdec, params, batch)
    with pytest.raises(NotImplementedError, match=r"A\.6\(d\)"):
        LM(encdec, params)
    # A config with an MoE block adds router_aux_weight times the aux
    # term, which is 0 for a model without MoE layers.
    moe = dataclasses.replace(cfg, moe=MoEConfig(4, 2, 64))
    assert torch.equal(loss_and_metrics(moe, params, batch)[0],
                       loss_and_metrics(cfg, params, batch)[0])


# ---------------------------------------------------------------------------
# B6's and B7's autograd Functions
# ---------------------------------------------------------------------------


def _grads(fn, inputs, cotangents):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o, g in zip(outs, cotangents)
                             if g is not None],
                            [g for g in cotangents if g is not None])
    return [t.grad for t in leaves]


def test_flash_attention_function_gradient_equals_plain_autograd():
    r = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 13, h, 16))
                                .astype(np.float32)) for h in (6, 2, 2))
    g = torch.from_numpy(r.normal(size=(2, 13, 6, 16)).astype(np.float32))
    for causal in (True, False):
        got = _grads(lambda *t: tops._FlashAttention.apply(*t, causal),
                     (q, k, v), (g,))
        want = _grads(lambda *t: tfa.flash_attention_plain(*t, causal),
                      (q, k, v), (g,))
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_function_gradient_equals_plain_autograd(with_state):
    r = np.random.default_rng(1)
    b, s, nh, p, n, chunk = 2, 20, 3, 8, 4, 8
    # x, B and C as column slices of one activation, as the model passes them.
    xbc = torch.from_numpy(r.normal(size=(b, s, nh * p + 2 * n))
                           .astype(np.float32))
    dt = torch.from_numpy(r.normal(size=(b, s, nh)).astype(np.float32))
    a_log = torch.from_numpy(r.uniform(0, 1, nh).astype(np.float32))
    d_skip = torch.from_numpy(r.normal(size=nh).astype(np.float32))
    gy = torch.from_numpy(r.normal(size=(b, s, nh, p)).astype(np.float32))
    gs = (torch.from_numpy(r.normal(size=(b, nh, n, p)).astype(np.float32))
          if with_state else None)

    def call(scan):
        def fn(xbc, dt, a_log, d_skip):
            x, bm, cm = torch.split(xbc, [nh * p, n, n], dim=-1)
            return scan(x.reshape(b, s, nh, p), dt, a_log, bm, cm, d_skip,
                        chunk)
        return _grads(fn, (xbc, dt, a_log, d_skip), (gy, gs))

    for a, c in zip(call(tops._SSDScan.apply), call(tssd.ssd_scan_plain)):
        assert torch.equal(a, c)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """A launch has no backward: a wrapper given a non-CPU input that
    requires grad in grad mode raises before it reaches the device checks
    (meta tensors stand in for CUDA ones here); under ``no_grad`` and
    through ``ops`` (whose Functions run the wrapper without grad) the
    device check is what refuses a meta tensor."""
    def meta(*shape, grad=True):
        return torch.empty(*shape, device="meta", requires_grad=grad)

    q, kv = meta(1, 4, 2, 16), meta(1, 4, 1, 16)
    x, dt, nh = meta(1, 4, 2, 8), meta(1, 4, 2), meta(2)
    bc = meta(1, 4, 4)
    calls = {
        "flash_attention": (tfa.flash_attention, (q, kv, kv)),
        "ssd_scan": (tssd.ssd_scan, (x, dt, nh, bc, bc, nh, 4)),
        "loss_confidence": (tlc.loss_confidence,
                            (meta(3, 5), meta(3, grad=False).int())),
    }
    for name, (fn, args) in calls.items():
        with pytest.raises(RuntimeError, match="require grad"):
            fn(*args)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd_scan(x, dt, nh, bc, bc, nh, 4)


# ---------------------------------------------------------------------------
# The LM module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [DENSE, SSM])
def test_lm_module_holds_one_parameter_per_layer_leaf(arch):
    cfg, jcfg = get_arch(arch).reduced(), jget_arch(arch).reduced()
    jp = jax.tree.map(np.asarray, jbuild_model(jcfg).init(jax.random.key(0)))
    stacked = transformer.params_from_jax(jp, "cpu")
    per_layer = transformer.params_from_jax(jp, "cpu", unstack=True)
    assert isinstance(per_layer["layers"], list)
    assert len(per_layer["layers"]) == cfg.num_layers
    lm = LM(cfg, stacked)
    sd = lm.state_dict()
    paths = [[k.key for k in path]
             for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    want = {p[0] for p in paths if p[0] != "layers"}
    want |= {".".join(["layers", str(i), *p[1:]]) for p in paths
             if p[0] == "layers" for i in range(cfg.num_layers)}
    assert set(sd) == want
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), _leaf(jp, name))
    ptrs = [p.data_ptr() for p in lm.parameters()]
    assert len(set(ptrs)) == len(ptrs)          # no shared storage
    # Serving takes the module's parameters as it takes the stacked tree.
    model = build_model(cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        a, ca = model.prefill(stacked, {"tokens": toks}, max_len=14)
        b, cb = model.prefill(lm.params(), {"tokens": toks}, max_len=14)
        assert torch.equal(a, b)
        a, _ = model.decode_step(stacked, toks[:, :1], ca)
        b, _ = model.decode_step(lm.params(), toks[:, :1], cb)
        assert torch.equal(a, b)
        full, _, _ = lm({"tokens": toks})
        ref, _, _ = transformer.forward(cfg, stacked, {"tokens": toks})
        assert torch.equal(full, ref)
