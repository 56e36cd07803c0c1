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
within 1e-5 of the decode without it.  As in the reference
(``transformer.py``'s sequence-parallel branch comes before the ring and
the window), a windowed arch decodes its whole cache there: hymba under
``seq_parallel_kv`` gives the decode with no window, not the windowed
one, and ``attention.decode_attend_sp`` over 8 ranks' spans is JAX's
``decode_attend`` with no window.  A world of one serves every model at
(1, 1): bit for bit the port without a context.
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


def _batch(cfg, s: int, seed: int = 1) -> dict:
    """A prompt batch of ``B`` rows: tokens, and the family's inputs
    (llava's patch embeddings, seamless-m4t's frames)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patch_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, S, cfg.encoder_input_dim)).astype(np.float32)
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
    rng = np.random.default_rng(5)
    attend = (rng.normal(size=(2, 1, 8, 16)).astype(np.float32),
              rng.normal(size=(2, 64, 4, 16)).astype(np.float32),
              rng.normal(size=(2, 64, 4, 16)).astype(np.float32), 45)
    ranks = spawn(sc.serve_world, 8, "gloo", "cpu", (cases, attend))
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
