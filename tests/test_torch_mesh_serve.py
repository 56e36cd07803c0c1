"""PyTorch port, serving over a ``("data", "model")`` mesh: prefill and
greedy decode on every rank's shards, and the sequence-parallel
flash-decode (``seq_parallel_kv``).

A gloo world of 8 CPU ranks is spawned once
(``tests/torch_mesh_serve_scenarios.py``).  In it ``dense-d`` and
``ssm-d`` (the reference's ``tests/test_distributed.py`` configs), a
reduced hymba-1.5b (4 layers, a prompt past its window of 32), the
reference test's ``moe-d`` in both FSDP layouts, and reduced llava and
seamless-m4t serve at (2, 4) with FSDP (``dense-d`` also at (4, 2)): a
prefill of 32 tokens (llava's 8 patch positions in front) of a batch of
8, then 4 greedy decode steps, every rank feeding the global batch's
argmax.  Each must give:

- the logits within 1e-5 of their max of the port on one device, and the
  same greedy tokens on every rank;
- the cache gathered whole (``Model.gather_cache``) within 1e-5 of one
  device's;
- for ``dense-d`` and ``ssm-d``, logits within 3e-3 of their max of the
  jitted JAX ``Model.prefill`` / ``decode_step`` on one device, and JAX's
  greedy tokens.

``seq_parallel_kv`` splits the cache's sequence over the model axis:
``dense-d`` at (2, 4) and (1, 8), a prompt of 33 and 4 steps into a cache
of 64 (37 positions filled: the ranks' spans are full, partial and empty),
within 1e-5 of the decode without it; at (2, 2) a prompt of 30 and 4
steps write positions 30-33, across the edge of model rank 0's span of
32 into rank 1's (the owner's write masked on the device: no rank reads
the position on the host), its tokens and logits one device's.  As in
the reference
(``transformer.py``'s sequence-parallel branch comes before the ring and
the window), a windowed arch decodes its whole cache there: hymba under
``seq_parallel_kv`` gives the decode with no window, not the windowed
one, and ``attention.decode_attend_sp`` over 8 ranks' spans is JAX's
``decode_attend`` with no window.  A world of one serves every model at
(1, 1): bit for bit the port without a context.

A batch of 1 divides no data axis: on blocks of the world as (2, 1) and
(2, 2) meshes, ``dense-d`` and ``ssm-d`` serve it (prefill of 32, 4
greedy steps) and take one LR-0 train step on it, every data rank
running the whole batch, as the reference's spec guard replicates it:
the logits and cache, and the loss, metrics and gradients, one
device's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.configs.registry import get_arch as jget_arch
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import spawn

import torch_mesh_serve_scenarios as sc
from torch_model_axis_scenarios import grads_step, random_batch

B, S, STEPS = 8, 32, 4
DENSE = dict(name="dense-d", family="dense", num_layers=2, d_model=64,
             num_heads=8, num_kv_heads=4, d_ff=128, vocab_size=256,
             head_dim=16, qk_norm=True)
SSM = dict(name="ssm-d", family="ssm", num_layers=2, d_model=64,
           num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=256)
MOE = dict(name="moe-d", family="moe", num_layers=2, d_model=64, num_heads=8,
           num_kv_heads=4, d_ff=0, vocab_size=256, head_dim=16)
HYMBA, LLAVA, SEAMLESS = ("hymba-1.5b", "llava-next-mistral-7b",
                          "seamless-m4t-large-v2")
#: hymba's prompt, past its window of 32.
HYMBA_S = 40
PARTIAL = dict(fsdp=True, moe_fsdp_mode="partial")
#: The sequence-parallel runs: a prompt of 33 and 4 steps in a cache of 64.
SP_S, SP_MAX = 33, 64
#: The sequence-parallel run at (2, 2) whose decode crosses from model rank
#: 0's span of 32 positions into rank 1's.
SP_CROSS_S = 30


def _configs() -> dict:
    """Each model's (port config, reference config)."""
    hymba = dataclasses.replace(get_arch(HYMBA).reduced(), num_layers=4)
    jhymba = dataclasses.replace(jget_arch(HYMBA).reduced(), num_layers=4)
    return {
        "dense-d": (ArchConfig(**DENSE), JArchConfig(**DENSE)),
        "ssm-d": (ArchConfig(**SSM, ssm=SSMConfig(16, 16, chunk=16)),
                  JArchConfig(**SSM, ssm=JSSMConfig(16, 16, chunk=16))),
        HYMBA: (hymba, jhymba),
        "moe-d": (ArchConfig(**MOE, moe=MoEConfig(8, 2, 64,
                                                  capacity_factor=8.0)),
                  JArchConfig(**MOE, moe=JMoEConfig(8, 2, 64,
                                                    capacity_factor=8.0))),
        LLAVA: (get_arch(LLAVA).reduced(), jget_arch(LLAVA).reduced()),
        SEAMLESS: (get_arch(SEAMLESS).reduced(),
                   jget_arch(SEAMLESS).reduced()),
    }


#: (case, model, mesh shape, build_ctx kwargs) of the world's runs.
RUNS = [("dense-d-2x4", "dense-d", (2, 4), dict(fsdp=True)),
        ("dense-d-4x2", "dense-d", (4, 2), dict(fsdp=True)),
        ("ssm-d-2x4", "ssm-d", (2, 4), dict(fsdp=True)),
        ("hymba-2x4", HYMBA, (2, 4), dict(fsdp=True)),
        ("moe-d-2x4", "moe-d", (2, 4), dict(fsdp=True)),
        ("moe-d-2x4-partial", "moe-d", (2, 4), PARTIAL),
        ("llava-2x4", LLAVA, (2, 4), dict(fsdp=True)),
        ("seamless-2x4", SEAMLESS, (2, 4), dict(fsdp=True))]
SP_RUNS = [("dense-d-2x4-sp", "dense-d", (2, 4)),
           ("dense-d-1x8-sp", "dense-d", (1, 8))]
#: A batch of 1, which divides no data axis of 2: every data rank takes it
#: whole (the reference's spec guard replicates it).  (model, mesh shape)
#: of the serve and train runs, on blocks of the world of 8.
B1_RUNS = [(name, shape) for name in ("dense-d", "ssm-d")
           for shape in ((2, 1), (2, 2))]
UNIT = [("dense-d", dict(fsdp=True)), ("ssm-d", dict(fsdp=True)),
        (HYMBA, dict(fsdp=True)), ("moe-d", dict(fsdp=True)),
        ("moe-d", PARTIAL), (LLAVA, dict(fsdp=True)),
        (SEAMLESS, dict(fsdp=True))]


def _params(jcfg, seed: int = 0) -> dict:
    """The reference's init as numpy, the attention projections at their
    input's fan-in and an SSM's ``a_log`` U[0, 1) (``tests/
    test_torch_model_axis.py``'s controls)."""
    params = jax.tree.map(np.array, jbuild_model(jcfg).init(
        jax.random.key(seed)))
    for key in ("layers", "enc_layers", "dec_layers"):
        layers = params.get(key)
        if layers is None:
            continue
        for name in ("attn", "xattn"):
            a = layers.get(name)
            if a is None:
                continue
            dh = jcfg.resolved_head_dim
            for w, fan in (("wq", jcfg.d_model), ("wk", jcfg.d_model),
                           ("wv", jcfg.d_model),
                           ("wo", jcfg.num_heads * dh)):
                a[w] = a[w] * np.float32((a[w].shape[-2] / fan) ** 0.5)
        if "ssm" in layers:
            layers["ssm"]["a_log"] = np.random.default_rng(0).uniform(
                0, 1, layers["ssm"]["a_log"].shape).astype(np.float32)
    return params


def _batch(cfg, s: int, seed: int = 1, b: int = B) -> dict:
    """A prompt batch of ``b`` rows: tokens, and the family's inputs
    (llava's patch embeddings, seamless-m4t's frames)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, cfg.num_patch_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, S, cfg.encoder_input_dim)).astype(np.float32)
    return batch


def _jax_greedy(jcfg, params: dict, batch: dict, max_len: int) -> dict:
    """The jitted JAX ``Model.prefill`` and ``STEPS`` greedy
    ``decode_step``s on one device."""
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, x: jm.prefill(p, x, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    decode = jax.jit(jm.decode_step)
    out, toks = [np.asarray(logits[:, -1])], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = decode(jp, tok, cache)
        out.append(np.asarray(logits[:, -1]))
    return {"logits": np.stack(out), "tokens": np.concatenate(toks, 1)}


@pytest.fixture(scope="module")
def worlds():
    cfgs = _configs()
    models = {}
    for name, (cfg, jcfg) in cfgs.items():
        s = HYMBA_S if name == HYMBA else S
        batch = _batch(cfg, s)
        models[name] = dict(cfg=cfg, jcfg=jcfg, params=_params(jcfg),
                            batch=batch,
                            max_len=s + STEPS + cfg.num_patch_tokens)
    cases, refs = [], {}
    for case, name, shape, kw in RUNS:
        m = models[name]
        cases.append((case, m["cfg"], m["params"], m["batch"], shape, kw,
                      m["max_len"], STEPS))
    for name, m in models.items():
        m["one"] = sc.greedy(m["cfg"], None, m["params"], m["batch"],
                             m["max_len"], STEPS)
        if name in ("dense-d", "ssm-d"):
            m["jax"] = _jax_greedy(m["jcfg"], m["params"], m["batch"],
                                   m["max_len"])
    dense = models["dense-d"]
    sp_batch = _batch(dense["cfg"], SP_S, seed=2)
    refs["sp"] = sc.greedy(dense["cfg"], None, dense["params"], sp_batch,
                           SP_MAX, STEPS)
    for case, name, shape in SP_RUNS:
        cases.append((case, dense["cfg"], dense["params"], sp_batch, shape,
                      dict(fsdp=True, seq_parallel_kv=True), SP_MAX, STEPS))
    cross_batch = _batch(dense["cfg"], SP_CROSS_S, seed=4)
    refs["sp_cross"] = sc.greedy(dense["cfg"], None, dense["params"],
                                 cross_batch, SP_MAX, STEPS)
    cases.append(("dense-d-2x2-sp-cross", dense["cfg"], dense["params"],
                  cross_batch, (2, 2), dict(fsdp=True, seq_parallel_kv=True),
                  SP_MAX, STEPS))
    hy = models[HYMBA]
    hy_max = 48                         # 12 positions a rank at (2, 4)
    refs["hymba_no_window"] = sc.greedy(
        hy["cfg"], None, hy["params"], hy["batch"], hy_max, STEPS,
        decode_cfg=dataclasses.replace(hy["cfg"], attn_window=None))
    refs["hymba_window"] = sc.greedy(hy["cfg"], None, hy["params"],
                                     hy["batch"], hy_max, STEPS)
    cases.append(("hymba-2x4-sp", hy["cfg"], hy["params"], hy["batch"],
                  (2, 4), dict(fsdp=True, seq_parallel_kv=True), hy_max,
                  STEPS))
    train_cases = []
    for name, shape in B1_RUNS:
        m = models[name]
        b1 = _batch(m["cfg"], S, seed=3, b=1)
        case = f"{name}-b1-{shape[0]}x{shape[1]}"
        cases.append((case, m["cfg"], m["params"], b1, shape,
                      dict(fsdp=True), m["max_len"], STEPS))
        if f"{name}-b1" not in refs:
            refs[f"{name}-b1"] = sc.greedy(m["cfg"], None, m["params"], b1,
                                           m["max_len"], STEPS)
            refs[f"{name}-b1-train"] = grads_step(
                m["cfg"], None, m["params"], random_batch(m["cfg"], 1, S))
        train_cases.append((f"{case}-train", m["cfg"], m["params"],
                            random_batch(m["cfg"], 1, S), shape,
                            dict(fsdp=True)))
    rng = np.random.default_rng(5)
    attend = (rng.normal(size=(2, 1, 8, 16)).astype(np.float32),
              rng.normal(size=(2, 64, 4, 16)).astype(np.float32),
              rng.normal(size=(2, 64, 4, 16)).astype(np.float32), 45)
    ranks = spawn(sc.serve_world, 8, "gloo", "cpu",
                  (cases, attend, train_cases))
    units = [(f"{name}{'-partial' if kw.get('moe_fsdp_mode') else ''}",
              models[name]["cfg"], models[name]["params"],
              models[name]["batch"], kw, models[name]["max_len"], STEPS)
             for name, kw in UNIT]
    one = spawn(sc.unit_serve_world, 1, "gloo", "cpu", (units,))[0]
    return models, refs, ranks, one, attend


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference relative to ``want``'s largest magnitude."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _check_serving(ranks: list, case: str, want: dict, tol: float = 1e-5):
    got = ranks[0][case]
    assert all(np.array_equal(r[case]["tokens"], got["tokens"])
               for r in ranks)
    err = _rel(got["logits"], want["logits"])
    print(f"{case}: logits rel err {err:.2e}")
    assert err <= tol, err
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["cache"].keys() == want["cache"].keys()
    assert got["cache"]["len"] == want["cache"]["len"]
    for k, w in want["cache"].items():
        if k != "len":
            assert got["cache"][k].shape == w.shape, k
            assert _rel(got["cache"][k], w) <= tol, k


@pytest.mark.parametrize("case,name,shape,kw", RUNS, ids=[r[0] for r in RUNS])
def test_mesh_serving_matches_one_device(worlds, case, name, shape, kw):
    """Prefill and 4 greedy decode steps on the mesh: the logits within
    1e-5 of their max of the port on one device, the tokens equal, the
    gathered cache within 1e-5."""
    models, _, ranks, _, _ = worlds
    _check_serving(ranks, case, models[name]["one"])


@pytest.mark.parametrize("name", ["dense-d", "ssm-d"])
def test_mesh_serving_matches_jax(worlds, name):
    """At (2, 4): within 3e-3 of their max of the jitted JAX prefill and
    decode on one device, and JAX's greedy tokens."""
    models, _, ranks, _, _ = worlds
    got, want = ranks[0][f"{name}-2x4"], models[name]["jax"]
    err = _rel(got["logits"], want["logits"])
    print(f"{name}: vs jax logits rel err {err:.2e}")
    assert err <= 3e-3
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("case", [r[0] for r in SP_RUNS])
def test_sequence_parallel_decode_matches_plain_decode(worlds, case):
    """``seq_parallel_kv``: the cache's 64 positions split over the model
    ranks, 37 filled at the end (a rank's span full, partial or empty):
    within 1e-5 of the decode without it, on every rank the same tokens,
    and the cache gathered over the data and model ranks within 1e-5."""
    _, refs, ranks, _, _ = worlds
    shape = {r[0]: r[2] for r in SP_RUNS}[case]
    got = ranks[0][case]
    s_loc = SP_MAX // shape[1]
    assert got["local_k"][2] == s_loc
    assert got["cache"]["len"] == SP_S + STEPS == 37
    assert 37 % s_loc != 0 and 37 < SP_MAX - s_loc
    _check_serving(ranks, case, refs["sp"])


def test_sequence_parallel_decode_crosses_a_span(worlds):
    """At (2, 2) under ``seq_parallel_kv`` the cache's 64 positions are two
    spans of 32: a prompt of 30 and 4 greedy steps write positions 30-33,
    from model rank 0's span into rank 1's, each step's owner picked on the
    device.  The tokens one device's on every rank, the logits and the
    gathered cache within 1e-5."""
    _, refs, ranks, _, _ = worlds
    got = ranks[0]["dense-d-2x2-sp-cross"]
    s_loc = got["local_k"][2]
    assert s_loc == SP_MAX // 2
    assert SP_CROSS_S < s_loc < SP_CROSS_S + STEPS
    assert got["cache"]["len"] == SP_CROSS_S + STEPS
    _check_serving(ranks, "dense-d-2x2-sp-cross", refs["sp_cross"])


def test_sequence_parallel_decode_ignores_the_window(worlds):
    """The reference's rule (ROADMAP C): under ``seq_parallel_kv`` the
    sequence-parallel branch comes before the ring and the window, so
    hymba (a prompt of 40 past its window of 32) decodes its whole cache
    in every layer: the port on one device decoding with no window, not
    the windowed decode."""
    _, refs, ranks, _, _ = worlds
    got = ranks[0]["hymba-2x4-sp"]
    err = _rel(got["logits"][1:], refs["hymba_no_window"]["logits"][1:])
    apart = _rel(refs["hymba_window"]["logits"][1:],
                 refs["hymba_no_window"]["logits"][1:])
    print(f"hymba sp: vs no window {err:.2e}, windowed vs not {apart:.2e}")
    assert err <= 1e-5
    assert apart > 1e-3
    np.testing.assert_array_equal(got["tokens"],
                                  refs["hymba_no_window"]["tokens"])


def test_decode_attend_sp_is_the_unwindowed_decode(worlds):
    """``attention.decode_attend_sp`` over the 8 ranks' spans of a cache
    of 64 (45 valid) is JAX's ``decode_attend`` with no window within
    1e-5, not the one with a window of 32."""
    *_, ranks, _, attend = worlds
    q, k, v, n = attend
    want = np.asarray(jattn.decode_attend(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.int32(n)))
    windowed = np.asarray(jattn.decode_attend(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(n),
        window=32, is_global=False))
    got = ranks[0]["attend_sp"]
    assert all(np.array_equal(r["attend_sp"], got) for r in ranks)
    assert float(np.abs(got - want).max()) <= 1e-5
    assert float(np.abs(got - windowed).max()) > 1e-3


@pytest.mark.parametrize("name", [
    f"{n}{'-partial' if kw.get('moe_fsdp_mode') else ''}" for n, kw in UNIT])
def test_unit_mesh_serving_is_one_device_bit_for_bit(worlds, name):
    got = worlds[3][name]
    assert got == {"logits": True, "tokens": True, "cache": True}, got


@pytest.mark.parametrize("name,shape", B1_RUNS,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in B1_RUNS])
def test_batch_one_serves_as_one_device(worlds, name, shape):
    """A batch of 1 on (2, 1) and (2, 2): each data rank prefills and
    decodes it whole, as the reference's spec guard replicates a batch
    that does not divide the data axes.  The logits within 1e-5 of one
    device's, the same tokens on every rank, and the cache whole on each
    rank (``gather_cache`` gathers no rows: batch 1, not 2)."""
    _, refs, ranks, _, _ = worlds
    case = f"{name}-b1-{shape[0]}x{shape[1]}"
    want = refs[f"{name}-b1"]
    assert ranks[0][case]["tokens"].shape == (1, STEPS)
    _check_serving(ranks, case, want)


@pytest.mark.parametrize("name,shape", B1_RUNS,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in B1_RUNS])
def test_batch_one_trains_as_one_device(worlds, name, shape):
    """One LR-0 train step of a batch of 1 on (2, 1) and (2, 2) with FSDP:
    the loss and the per-sample loss, PA and PC are one device's, and
    every gradient, summed over the data ranks by the train step and
    FSDP's scatter, is one device's (``dp_share`` divides each rank's
    share), within 1e-5 of its leaf's largest magnitude; the same loss on
    every rank."""
    _, refs, ranks, _, _ = worlds
    case = f"{name}-b1-{shape[0]}x{shape[1]}-train"
    got, want = ranks[0][case], refs[f"{name}-b1-train"]
    assert all(r[case]["loss"] == got["loss"] for r in ranks)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6, abs=0)
    assert got["lv"].shape == (1,)
    np.testing.assert_allclose(got["lv"], want["lv"], rtol=1e-6)
    np.testing.assert_array_equal(got["pa"], want["pa"])
    np.testing.assert_allclose(got["pc"], want["pc"], rtol=1e-6)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        assert got["grads"][k].shape == w.shape, k
        assert _rel(got["grads"][k], w) <= 1e-5, k
