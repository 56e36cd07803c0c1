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
reference's is plain jnp.  The VLM (llava) gets ``num_patch_tokens``
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
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import VLM_PATCH_DIM


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 16, seed: int = 0,
          greedy: bool = True, verbose: bool = True,
          device: str | torch.device | None = None,
          num_layers: int | None = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen_tokens`` tokens (greedy).  Weights are drawn on the device from a
    ``torch.Generator`` seeded with ``seed`` (a card draws other numbers
    than the CPU, of the same distributions); prompts, and the encdec's
    frames or the VLM's patch embeddings after them, from numpy's
    ``default_rng(seed)``.  ``num_layers`` cuts the depth (the encdec's
    encoder and decoder alike).  ``device=None`` means CUDA."""
    dev = resolve_device(device)
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
    t1 = time.perf_counter()
    for _ in range(gen_tokens):
        out_tokens.append(tok)
        logits, cache = model.decode_step(params, tok, cache)
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
    if verbose:
        print(f"arch={cfg.name} layers={cfg.num_layers} batch={batch} "
              f"prompt={prompt_len} gen={gen_tokens} device={dev}")
        print(f"prefill: {t_prefill * 1e3:.1f} ms   "
              f"decode: {stats['decode_per_token_ms']:.1f} ms/tok   "
              f"throughput: {stats['decode_tok_per_s']:.1f} tok/s")
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
