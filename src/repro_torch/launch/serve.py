"""Batched serving: prefill a prompt batch, decode N tokens.

Port of ``repro/launch/serve.py`` for the architectures the port runs
(``repro_torch.configs.registry``; ``--full`` for the published widths,
else the reduced config).  Reports prefill latency and per-token decode
latency and throughput; on the card each time is taken between two
``torch.cuda.synchronize()``.  On the card, prefill runs attention through
kernel B7 (smollm-135m, the default) or the SSD scan through kernel B6
(mamba2-130m); decode is plain PyTorch (attention against the KV cache, or
the recurrent update).

    python -m repro_torch.launch.serve --full
    python -m repro_torch.launch.serve --device cpu
    python -m repro_torch.launch.serve --arch mamba2-130m --full
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 16, seed: int = 0,
          greedy: bool = True, verbose: bool = True,
          device: str | torch.device | None = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then decode
    ``gen_tokens`` tokens (greedy).  Weights are drawn from a
    ``torch.Generator`` seeded with ``seed``, prompts from numpy's
    ``default_rng(seed)``.  ``device=None`` means CUDA."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, dev)
    params = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    max_len = prompt_len + gen_tokens + cfg.num_patch_tokens

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=max_len)
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
        print(f"arch={cfg.name} batch={batch} prompt={prompt_len} "
              f"gen={gen_tokens} device={dev}")
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
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    args = p.parse_args(argv)
    serve(args.arch, reduced=not args.full, batch=args.batch,
          prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
          seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
