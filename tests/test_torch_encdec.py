"""PyTorch port, the encoder-decoder (seamless-m4t-large-v2) against JAX.

The reduced config (2 + 2 layers, d_model 64, 4 query and 2 KV heads, frames
of 32), from the reference's parameters carried by
``transformer.params_from_jax``, under the conditioning control of
``tests/test_torch_lm.py`` (every attention projection, self and cross, at
its input's fan-in), on the CPU:

- ``encode`` and the forward's logits within 1e-5 (``_close``);
- ``loss_and_metrics`` (weighted, masked) and every leaf's gradient
  against ``jax.grad`` of the reference's ``Model.loss_and_metrics``, 1e-5
  relative per leaf;
- prefill and 8 greedy decode steps against the JAX ``Model``: logits and
  ``k``/``v``/``xk``/``xv`` within 1e-5, the tokens and ``len`` equal;
- ``cross_attend`` against the reference's with S_q != S_k and Hq != Hkv;
  ``Model.init_cache``'s shapes (the encoder length ``max_len //
  DEC_FRACTION``) equal the reference's;
- ``serve(..., device="cpu")`` draws the frames after the tokens, as the
  reference's serve does, and ``--layers`` cuts both stacks;
- ``LM``'s parameter names (``enc_layers.1.attn.wq``,
  ``dec_layers.0.xattn.wo``, ...) and its leaves equal the tree's;
- 3 KAKURENBO epochs against the JAX ``Trainer`` on a frames batch source
  defined here (SyntheticLM's sequences at seq // DEC_FRACTION beside
  N(0, 1) frames), with the reference's permutations: plans equal, losses
  within 1e-4 relative; the scanned engine bit-identical to the host loop.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import KakurenboConfig as JKakurenboConfig
from repro.core import LRSchedule as JLRSchedule
from repro.core import planops as jplanops
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models.model import DEC_FRACTION as JDEC_FRACTION
from repro.models.model import ENC_FRAME_DIM as JENC_FRAME_DIM
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_arch
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticLM
from repro_torch.launch import serve as serve_mod
from repro_torch.models import LM, attention, build_model, encdec, transformer
from repro_torch.models.model import DEC_FRACTION, ENC_FRAME_DIM
from repro_torch.train import Trainer, TrainConfig

ARCH = "seamless-m4t-large-v2"
TOL = 1e-5


def _condition(jp: dict, cfg) -> dict:
    """Every attention projection (self and cross, both stacks) at its
    input's fan-in, on a numpy tree."""
    dh = cfg.resolved_head_dim
    for stack, blocks in (("enc_layers", ("attn",)),
                          ("dec_layers", ("attn", "xattn"))):
        for block in blocks:
            a = jp[stack][block]
            for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                              ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
                a[name] = a[name] * np.float32((a[name].shape[-2] / fan) ** 0.5)
    return jp


def _reference(seed: int = 0):
    cfg, jcfg = get_arch(ARCH).reduced(), jget_arch(ARCH).reduced()
    jm = jbuild_model(jcfg)
    jp = _condition(jax.tree.map(np.array, jm.init(jax.random.key(seed))), cfg)
    return cfg, jm, jp


def _close(a, b, tol=TOL):
    b = np.asarray(b)
    scale = max(1.0, float(np.abs(b).max())) if b.size else 1.0
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol, atol=tol * scale)


def _frames(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.encoder_input_dim)).astype(np.float32)


def _batch(cfg, b: int = 3, s: int = 24, seed: int = 0) -> dict:
    """A train batch: frames of ``s`` positions, SyntheticLM tokens of
    ``s // DEC_FRACTION`` with masked positions, a weight per sample."""
    ds = SyntheticLM(num_samples=b, seq_len=s // DEC_FRACTION, vocab_size=64,
                     order=1, easy_fraction=0.7, seed=seed)
    batch = ds.get(np.arange(b))
    r = np.random.default_rng(seed)
    batch["mask"] = r.random(batch["tokens"].shape) < 0.8
    batch["weight"] = r.random(b).astype(np.float32)
    batch["frames"] = _frames(cfg, b, s, seed)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


def _leaf(tree, name):
    parts = name.split(".")
    if parts[0] not in ("enc_layers", "dec_layers"):
        return tree[parts[0]]
    node = tree[parts[0]]
    for k in parts[2:]:
        node = node[k]
    return node[int(parts[1])]


def test_constants_and_registry():
    assert (ENC_FRAME_DIM, DEC_FRACTION) == (JENC_FRAME_DIM, JDEC_FRACTION)
    cfg = get_arch(ARCH)
    assert cfg.family == "encdec" and cfg.encoder_input_dim == ENC_FRAME_DIM
    red = cfg.reduced()
    assert (red.num_layers, red.num_encoder_layers, red.encoder_input_dim) \
        == (2, 2, 32)


def test_encode_and_forward_match_jax():
    cfg, jm, jp = _reference(seed=1)
    batch = _batch(cfg, b=2, s=24, seed=1)
    del batch["weight"]
    tp = transformer.params_from_jax(jp, "cpu")
    jenc = jencdec.encode(jm.cfg, jm.ctx, jp, jnp.asarray(batch["frames"]))
    tenc = encdec.encode(cfg, tp, torch.from_numpy(batch["frames"]))
    assert tenc.shape == jenc.shape == (2, 24, cfg.d_model)
    _close(tenc, jenc)
    jl, jmask, _ = jencdec.forward(jm.cfg, jm.ctx, jp,
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmask, taux = encdec.forward(
        cfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tl.shape == jl.shape == (2, 24 // DEC_FRACTION, cfg.vocab_size)
    _close(tl, jl)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert taux.item() == 0.0


def test_loss_and_gradients_match_jax():
    cfg, jm, jp = _reference()
    batch = _batch(cfg)
    (js, (jl, jpa, jpc)), jg = jax.value_and_grad(
        jm.loss_and_metrics, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lm = LM(cfg, transformer.params_from_jax(jp, "cpu", unstack=True))
    scalar, (loss, pa, pc) = lm.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    scalar.backward()
    np.testing.assert_allclose(scalar.item(), float(js), rtol=TOL)
    np.testing.assert_allclose(loss.detach().numpy(), jl, rtol=TOL, atol=1e-6)
    assert np.array_equal(pa.numpy(), np.asarray(jpa))
    np.testing.assert_allclose(pc.detach().numpy(), jpc, rtol=1e-6, atol=1e-6)
    jg = jax.tree.map(np.asarray, jg)
    names = [n for n, _ in lm.named_parameters()]
    stacks = ("enc_layers", "dec_layers")
    assert len(names) == sum(len(jax.tree.leaves(jg[s])) for s in stacks) \
        * cfg.num_layers + len([k for k in jg if k not in stacks])
    for name, p in lm.named_parameters():
        want = _leaf(jg, name)
        assert p.grad is not None and p.grad.shape == want.shape, name
        rel = np.linalg.norm(p.grad.numpy() - want) / np.linalg.norm(want)
        assert rel <= TOL, (name, rel)


def _same_caches(tc, jc):
    assert tc.keys() == jc.keys() == {"len", "k", "v", "xk", "xv"}
    assert tc["len"] == int(jc["len"])
    for k in tc:
        if k != "len":
            assert tuple(tc[k].shape) == jc[k].shape, k
            _close(tc[k], jc[k])


@pytest.mark.parametrize("b,s_enc,s", [(2, 24, 6), (3, 10, 13)])
def test_prefill_and_greedy_decode_match_jax(b, s_enc, s):
    cfg, jm, jp = _reference(seed=2)
    steps = 8
    r = np.random.default_rng(s)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "frames": _frames(cfg, b, s_enc, s)}
    max_len = s + steps
    jl, jc = jax.jit(lambda p, x: jm.prefill(p, x, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tp = build_model(cfg, device="cpu"), transformer.params_from_jax(jp, "cpu")
    tl, tc = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                        max_len=max_len)
    assert tl.shape == (b, 1, cfg.vocab_size)
    _close(tl, jl)
    _same_caches(tc, jc)
    assert tc["len"] == s and tc["xk"].shape[2] == s_enc
    jdecode = jax.jit(jm.decode_step)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = tl[:, -1:].argmax(dim=-1)
    for step in range(steps):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), step
        jl, jc = jdecode(jp, jtok, jc)
        tl, tc = tm.decode_step(tp, ttok, tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        ttok = tl[:, -1:].argmax(dim=-1)
    _same_caches(tc, jc)
    assert tc["len"] == s + steps


@pytest.mark.parametrize("sq,sk,hq,hkv", [(5, 17, 4, 2), (12, 3, 6, 1),
                                          (7, 7, 4, 4)])
def test_cross_attend_matches_jax(sq, sk, hq, hkv):
    r = np.random.default_rng(sq * sk)
    q = r.normal(size=(2, sq, hq, 16)).astype(np.float32)
    k, v = (r.normal(size=(2, sk, hkv, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn.cross_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = attention.cross_attend(*(torch.from_numpy(t) for t in (q, k, v)))
    assert got.shape == want.shape == (2, sq, hq, 16)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("full", [False, True])
def test_init_cache_matches_reference(full):
    cfg, jcfg = get_arch(ARCH), jget_arch(ARCH)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    b, max_len = 2, (64 if full else 40)
    want = jbuild_model(jcfg).init_cache(b, max_len, dtype=jnp.float32)
    got = build_model(cfg, device="cpu").init_cache(b, max_len, dtype=torch.float32)
    assert got.keys() == want.keys()
    assert got["len"] == int(want["len"]) == 0
    for k in ("k", "v", "xk", "xv"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32 and not got[k].any()
    assert got["xk"].shape[2] == max_len // DEC_FRACTION


def test_serve_draws_the_references_frames(monkeypatch):
    """The prompt batch: tokens, then (B, prompt, 32) frames from the same
    ``default_rng(seed)``, as the reference's serve draws them."""
    seen = []
    prefill = encdec.prefill

    def spy(cfg, params, batch, max_len=None):
        seen.append(({k: v.numpy().copy() for k, v in batch.items()}, max_len))
        return prefill(cfg, params, batch, max_len)

    monkeypatch.setattr(encdec, "prefill", spy)
    got = serve_mod.serve(ARCH, device="cpu", batch=2, prompt_len=6,
                          gen_tokens=3, seed=4, verbose=False)
    (batch, max_len), = seen
    rng = np.random.default_rng(4)
    assert np.array_equal(batch["tokens"], rng.integers(0, 257, (2, 6)))
    assert np.array_equal(batch["frames"], rng.normal(size=(2, 6, 32)).astype(
        np.float32))
    assert max_len == 6 + 3
    assert got["generated"].shape == (2, 3)
    assert ((0 <= got["generated"]) & (got["generated"] < 257)).all()


def test_serve_layers_cut_both_stacks(monkeypatch):
    seen = []
    build = serve_mod.build_model

    def spy(cfg, ctx=None, device=None):
        seen.append(cfg)
        return build(cfg, ctx, device)

    monkeypatch.setattr(serve_mod, "build_model", spy)
    serve_mod.serve(ARCH, device="cpu", batch=1, prompt_len=4, gen_tokens=1,
                    verbose=False, num_layers=1)
    assert (seen[0].num_layers, seen[0].num_encoder_layers) == (1, 1)


def test_lm_parameter_names():
    cfg, _, jp = _reference()
    lm = LM(cfg, transformer.params_from_jax(jp, "cpu"))
    names = dict(lm.named_parameters())
    for name in ("enc_in", "enc_norm", "embed", "out_norm", "lm_head",
                 "enc_layers.1.attn.wq", "enc_layers.0.mlp.w_down",
                 "dec_layers.0.xattn.wo", "dec_layers.1.lnx",
                 "dec_layers.1.attn.wk"):
        assert name in names, name
    assert not any("q_norm" in n for n in names)
    assert len(lm.enc_layers) == cfg.num_encoder_layers
    assert len(lm.dec_layers) == cfg.num_layers
    for name, p in names.items():
        np.testing.assert_array_equal(p.detach().numpy(), _leaf(jp, name))
    tree = lm.params()
    assert isinstance(tree["enc_layers"], list)
    assert tree["dec_layers"][1]["xattn"]["wv"] is names["dec_layers.1.xattn.wv"]


# ---------------------------------------------------------------------------
# KAKURENBO training against the JAX Trainer
# ---------------------------------------------------------------------------

SEQ, BATCH, EPOCHS, NUM = 16, 16, 3, 64
KAKURENBO = dict(max_fraction=0.3, tau=0.2,
                 fraction_milestones=(0, EPOCHS // 3, EPOCHS // 2,
                                      3 * EPOCHS // 4))


class FramesLM:
    """A frames batch source: ``lm_cls``'s sequences of ``seq //
    DEC_FRACTION`` tokens beside N(0, 1) frames of (seq, ``dim``) drawn
    from ``default_rng(seed)``, as the reference's tests build an encdec
    batch (the package has no frames dataset)."""

    def __init__(self, lm_cls, num_samples: int, seq: int, dim: int,
                 seed: int = 0):
        self.lm = lm_cls(num_samples=num_samples, seq_len=seq // DEC_FRACTION,
                         vocab_size=64, order=1, easy_fraction=0.7, seed=seed)
        self.frames = np.random.default_rng(seed).normal(
            size=(num_samples, seq, dim)).astype(np.float32)
        self.num_samples = num_samples

    def get(self, indices) -> dict:
        batch = self.lm.get(indices)
        batch["frames"] = self.frames[np.asarray(indices)]
        return batch


def _run_jax():
    cfg, jm, _ = _reference()
    tc = JTrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        optimizer="adamw", optimizer_hp={},
        lr=JLRSchedule(1e-2, "cosine", EPOCHS, 1),
        kakurenbo=JKakurenboConfig(**KAKURENBO), seed=0)

    def loss_fn(params, batch):
        return jm.loss_and_metrics(
            params, {k: jnp.asarray(v) for k, v in batch.items()})

    tr = JTrainer(tc, lambda rng: jax.tree.map(
        jnp.asarray, _condition(jax.tree.map(np.array, jm.init(rng)), cfg)),
        loss_fn, FramesLM(JSyntheticLM, NUM, SEQ, cfg.encoder_input_dim), None)
    init = jax.tree.map(np.asarray, tr.params)
    plans = _recording(tr)
    return init, tr.run(), plans


def _recording(trainer):
    plans, plan = [], trainer.strategy.plan
    trainer.strategy.plan = lambda e: (lambda p: plans.append(p) or p)(plan(e))
    return plans


def make(engine: str = "auto", params: dict | None = None, seed: int = 0,
         **tc_kw) -> Trainer:
    cfg = get_arch(ARCH).reduced()
    tc = TrainConfig(
        epochs=EPOCHS, batch_size=BATCH, strategy="kakurenbo",
        optimizer="adamw", optimizer_hp={}, engine=engine,
        lr=LRSchedule(1e-2, "cosine", EPOCHS, 1),
        kakurenbo=KakurenboConfig(**KAKURENBO), seed=seed, **tc_kw)
    model = (LM(cfg, transformer.params_from_jax(params, "cpu")) if params
             else LM.init(cfg, torch.Generator().manual_seed(seed), "cpu"))
    return Trainer(tc, model, lambda m, b: m.loss_and_metrics(b),
                   FramesLM(SyntheticLM, NUM, SEQ, cfg.encoder_input_dim),
                   None, device="cpu")


def test_kakurenbo_matches_jax_trainer():
    init, jhist, jplans = _run_jax()
    tr = make(params=init)
    assert tr.engine.name == "scan"
    key, perms = jplanops.strategy_key(0, "kakurenbo"), []
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(sub, NUM))))
    it = iter(perms)
    tr.strategy._inner.draw_permutation = lambda: next(it)
    plans = _recording(tr)
    hist = tr.run()
    assert any(len(p.hidden_indices) for p in plans), "no epoch hid anything"
    for h, j, tp, jp in zip(hist, jhist, plans, jplans):
        assert h.hidden_fraction == j.hidden_fraction
        assert (h.fwd_samples, h.bwd_samples) == (j.fwd_samples, j.bwd_samples)
        assert h.train_loss == pytest.approx(j.train_loss, rel=1e-4)
        np.testing.assert_array_equal(tp.visible_indices, jp.visible_indices)
        np.testing.assert_array_equal(tp.hidden_indices, jp.hidden_indices)
    assert hist[-1].train_loss < hist[0].train_loss


def test_scan_bit_identical_to_host_loop():
    _, _, jp = _reference()
    runs = {}
    for engine in ("host", "scan"):
        tr = make(engine, params=jp, scan_steps=3)
        plans = _recording(tr)
        tr.run()
        runs[engine] = (tr, plans)
    (h, ph), (s, ps) = runs["host"], runs["scan"]
    assert (h.engine.name, s.engine.name) == ("host", "scan")
    sh = {p: ckpt.to_numpy(v) for p, v in ckpt.flatten(h._ckpt_tree())}
    ss = {p: ckpt.to_numpy(v) for p, v in ckpt.flatten(s._ckpt_tree())}
    assert sh.keys() == ss.keys()
    assert any(k.startswith("/params/enc_layers.1.") for k in sh)
    for k in sh:
        assert sh[k].tobytes() == ss[k].tobytes(), k
    assert [x.train_loss for x in h.history] == [x.train_loss for x in s.history]
    for x, y in zip(ph, ps):
        np.testing.assert_array_equal(x.visible_indices, y.visible_indices)
        np.testing.assert_array_equal(x.hidden_indices, y.hidden_indices)
    assert any(len(p.hidden_indices) for p in ps)


def test_frames_source_rows():
    ds = FramesLM(SyntheticLM, 8, SEQ, 32, seed=3)
    idx = np.array([0, 7, 3, 3])
    b = ds.get(idx)
    assert b["frames"].shape == (4, SEQ, 32) and b["tokens"].shape == (4, 4)
    assert b["frames"].tobytes() == ds.frames[idx].tobytes()
    assert dataclasses.is_dataclass(get_arch(ARCH))


def test_lm_example_refuses_the_encdec():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / "torch_lm_train.py"
    spec = importlib.util.spec_from_file_location("torch_lm_train", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(ValueError, match="frames"):
        mod.make_trainer(ARCH, device="cpu", ckpt_dir=None)
