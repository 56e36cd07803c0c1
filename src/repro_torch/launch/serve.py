"""Batched serving: prefill a prompt batch, decode N tokens.

Port of ``repro/launch/serve.py`` for the registry's ten architectures
(``repro_torch.configs.registry``; ``--full`` for the published widths,
else the reduced config; ``--layers`` cuts the depth, of both stacks for
the encoder-decoder).  Reports prefill latency and per-token decode
latency and throughput; on the card each time is taken between two
``torch.cuda.synchronize()``.  On the card, prefill runs attention through
kernel B7 (outside a sliding window) and the SSD scan through kernel B6
(mamba2-130m, hymba-1.5b), the encoder-decoder's encoder and decoder
self-attention through B7 too; decode (and cross-attention) is plain
PyTorch (attention against the KV cache, the recurrent update), as the
reference's is plain jnp.

The reference compiles its decode step (``jax.jit(model.decode_step)``);
the port captures it: ``capture_decode`` records one ``decode_step`` as a
CUDA graph, and ``serve`` decodes through it on the card (``graph=False``:
eagerly, one PyTorch call at a time; the CPU always decodes eagerly).
Prefill stays eager: its time is the kernels', not their launches.  A
sharded ``Model`` decodes eagerly: gloo's collectives run on the host,
where a graph cannot hold them.  The VLM (llava) gets ``num_patch_tokens``
random patch embeddings in front of each prompt, the encoder-decoder
(seamless) ``prompt_len`` random frames of ``encoder_input_dim``, as the
reference draws them.

    python -m repro_torch.launch.serve --full
    python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch mamba2-130m --full
    python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --full \
        --layers 4 --prompt-len 2048 --gen-tokens 32
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 --full
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model
from repro_torch.models.model import Model
from repro_torch.models.transformer import VLM_PATCH_DIM


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: The cache entries a decode step writes in place (the others it returns
#: as new tensors).
_IN_PLACE = ("k", "v")


class CapturedDecode:
    """One ``Model.decode_step`` captured as a CUDA graph: called as
    ``(params, token, cache) -> (logits, cache)``, as ``decode_step`` is.
    Made by ``capture_decode``.

    It holds a static (B, 1) token buffer, the cache it was captured on
    (the static cache: the caller's tensors, which every call writes in
    place) and the graph's private memory pool.  The graph runs one
    ``decode_step``, copies the step's new SSM state and conv buffer into
    the static cache's and advances its ``len`` in place.  A call checks
    that ``params`` and ``cache`` hold the tensors it was captured on (by
    ``data_ptr``) and that TF32 in cuBLAS is as it was at the capture,
    raising otherwise, copies ``token`` in, replays, and returns the
    static logits (B, 1, V) and the static cache.  The logits are
    overwritten by the next call: read them (the greedy ``argmax``) first.

    ``capture_s``: the capture's seconds, its warm-up included;
    ``pool_bytes``: the bytes the capture reserved, the graph pool's
    peak."""

    def __init__(self, model: Model, params, token: torch.Tensor,
                 cache: dict):
        dev = cache["len"].device
        t0 = time.perf_counter()
        self.token = token.clone()
        self.cache = dict(cache)
        self.tf32 = torch.backends.cuda.matmul.allow_tf32
        self._held = _addresses(params, self.cache)
        side, main = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
        # Warm-up (cuBLAS handles and workspaces, the allocator) on the
        # capture's stream; the k and v it writes are restored after it.
        saved = [self.cache[k].clone() for k in _IN_PLACE if k in self.cache]
        side.wait_stream(main)
        with torch.no_grad(), torch.cuda.stream(side):
            model.decode_step(params, self.token, self.cache)
        main.wait_stream(side)
        for k, t in zip(_IN_PLACE, saved):
            self.cache[k].copy_(t)
        del saved
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        # A garbage collection inside the capture may free another graph's
        # memory, a CUDA call the capture does not allow: hold the
        # collector off until it ends (as train/engines.py does).
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.no_grad(), torch.cuda.graph(self.graph, stream=side):
                self.logits, new = model.decode_step(params, self.token,
                                                     self.cache)
                for k in ("ssm_state", "conv_buf", "len"):
                    if k in new:
                        self.cache[k].copy_(new[k])
        finally:
            if gc_was_enabled:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def __call__(self, params, token: torch.Tensor, cache: dict):
        if _addresses(params, cache) != self._held:
            raise ValueError(
                "a captured decode step was called with parameters or a "
                "cache other than the tensors it was captured on (pass the "
                "cache it returned; capture again for other tensors)")
        if torch.backends.cuda.matmul.allow_tf32 != self.tf32:
            raise ValueError(
                "a captured decode step was captured with cuda.matmul."
                f"allow_tf32={self.tf32}: the flag has changed since, and "
                "the graph would not follow it (capture again)")
        self.token.copy_(token)
        self.graph.replay()
        return self.logits, self.cache


def _addresses(params, cache: dict) -> tuple:
    return (tuple(t.data_ptr() for t in tree_leaves(params)),
            tuple((k, cache[k].data_ptr()) for k in sorted(cache)))


def capture_decode(model: Model, params, token: torch.Tensor,
                   cache: dict) -> CapturedDecode:
    """The port's ``jax.jit(model.decode_step)``: ``model``'s decode step
    on ``params``, a (B, 1) ``token`` and ``cache`` (a prefill's, or
    ``Model.init_cache``'s, the ring too) captured as one CUDA graph
    (``CapturedDecode``).  The cache given becomes the step's static
    cache.  Raises ``ValueError`` on the CPU (a graph needs CUDA tensors:
    call ``model.decode_step``) and for a sharded ``Model`` (its decode
    runs collectives; over gloo they run on the host, where a graph cannot
    hold them)."""
    if model.sharded:
        raise ValueError(
            "capture_decode: a sharded Model decodes eagerly (its "
            "collectives run on the host over gloo, where a CUDA graph "
            "cannot hold them)")
    where = {cache["len"].device.type, token.device.type}
    if where != {"cuda"}:
        raise ValueError(
            f"capture_decode: a CUDA graph needs CUDA tensors, and the "
            f"cache and token are on {sorted(where)} (decode eagerly with "
            "model.decode_step)")
    return CapturedDecode(model, params, token, cache)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 16, seed: int = 0,
          greedy: bool = True, verbose: bool = True,
          device: str | torch.device | None = None,
          num_layers: int | None = None, graph: bool | None = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen_tokens`` tokens (greedy).  Weights are drawn on the device from a
    ``torch.Generator`` seeded with ``seed`` (a card draws other numbers
    than the CPU, of the same distributions); prompts, and the encdec's
    frames or the VLM's patch embeddings after them, from numpy's
    ``default_rng(seed)``.  ``num_layers`` cuts the depth (the encdec's
    encoder and decoder alike).  ``device=None`` means CUDA.  ``graph``:
    decode through ``capture_decode`` (captured after the prefill, before
    the timed decode; its seconds apart, as the one key beyond the
    reference's, ``decode_capture_s``);
    ``None`` captures on CUDA and decodes eagerly on the CPU, ``False``
    decodes eagerly, ``True`` on the CPU raises ``ValueError``."""
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"serve(graph=True): decode is captured as a CUDA "
                         f"graph, and device={dev} is not CUDA")
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if num_layers is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=num_layers,
            num_encoder_layers=num_layers if cfg.num_encoder_layers else 0)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    pbatch = {"tokens": toks}
    if cfg.family == "encdec":
        pbatch["frames"] = torch.from_numpy(rng.normal(
            size=(batch, prompt_len, cfg.encoder_input_dim)).astype(
                np.float32)).to(dev)
    if cfg.family == "vlm":
        pbatch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(batch, cfg.num_patch_tokens, VLM_PATCH_DIM)).astype(
                np.float32)).to(dev)
    max_len = prompt_len + gen_tokens + cfg.num_patch_tokens

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, pbatch, max_len=max_len)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = logits[:, -1:].argmax(dim=-1)
    step, captured = model.decode_step, None
    if graph:
        step = captured = capture_decode(model, params, tok, cache)
    t1 = time.perf_counter()
    for _ in range(gen_tokens):
        out_tokens.append(tok)
        logits, cache = step(params, tok, cache)
        tok = logits[:, -1:].argmax(dim=-1) if greedy else tok
    _sync(dev)
    t_decode = time.perf_counter() - t1

    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    stats = {
        "arch": cfg.name,
        "prefill_s": t_prefill,
        "decode_per_token_ms": t_decode / gen_tokens * 1e3,
        "decode_tok_per_s": batch * gen_tokens / t_decode,
        "generated": gen,
    }
    if captured is not None:
        stats["decode_capture_s"] = captured.capture_s
    if verbose:
        print(f"arch={cfg.name} layers={cfg.num_layers} batch={batch} "
              f"prompt={prompt_len} gen={gen_tokens} device={dev}")
        print(f"prefill: {t_prefill * 1e3:.1f} ms   "
              f"decode: {stats['decode_per_token_ms']:.1f} ms/tok   "
              f"throughput: {stats['decode_tok_per_s']:.1f} tok/s")
        if captured is not None:
            print(f"decode captured as a CUDA graph: "
                  f"{captured.capture_s * 1e3:.1f} ms to capture, pool "
                  f"{captured.pool_bytes / 2**20:.1f} MiB")
        print("sample tokens:", gen[0][:12].tolist())
    return stats


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--full", action="store_true",
                   help="the published widths and depth (else reduced)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many layers")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    serve(args.arch, reduced=not args.full, batch=args.batch,
          prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
          seed=args.seed, device=args.device, num_layers=args.layers)


if __name__ == "__main__":
    main()
