"""End-to-end LM pretraining with KAKURENBO sequence hiding, on the PyTorch port.

    PYTHONPATH=src python examples/torch_lm_train.py --steps 200      # reduced
    PYTHONPATH=src python examples/torch_lm_train.py --full           # smollm-135m
    PYTHONPATH=src python examples/torch_lm_train.py --arch mamba2-130m --full
    PYTHONPATH=src python examples/torch_lm_train.py --device cpu --steps 16 \\
        --num-samples 64 --batch 16 --ckpt-dir ''
    PYTHONPATH=src python examples/torch_lm_train.py --full \\
        --arch phi3.5-moe-42b-a6.6b --layers 2 --ckpt-dir ''
    PYTHONPATH=src python examples/torch_lm_train.py --full \\
        --arch hymba-1.5b --lr 1e-3 --ckpt-dir ''

The counterpart of ``examples/lm_train.py``, with its flags, defaults and
setup: a registry architecture (any decoder-only one, as in the reference,
whose ``SyntheticLM`` batches carry no frames for the encoder-decoder
seamless-m4t; reduced unless
``--full``; ``--layers`` cuts the depth, so that a large model trains at its
full width on one card) trained on the
synthetic LM corpus (``SyntheticLM``: vocab 64, order 1, 70% easy) with
AdamW, a cosine LR of 1e-2 (``--lr``) with one warm-up epoch, KAKURENBO at F = 0.3
with milestones at e/3, e/2 and 3e/4, and a checkpoint every e/4 epochs
(``--ckpt-dir ''`` takes none; ``--resume`` restores the newest).  A
"sample" is a sequence: its loss is the mean token CE, its PC the mean max
softmax probability and its PA token accuracy >= 0.5
(``models/transformer.py::per_sample_metrics``).  It runs on CUDA unless
``--device cpu`` is given, through the trainer's default engine (the corpus
on the device, each block of steps one CUDA graph replay); there every
forward runs kernel B7 (the attention of every arch but mamba2-130m) and
B6 (mamba2-130m's and hymba-1.5b's SSM) once a layer and kernel B1 over the
(batch x seq, vocab) logits, and every train step B1's backward kernel.
The VLM trains on the text alone, as the reference's example does.  ``--selection`` picks the plan's selection
(``"sort"``, the reference's; ``"histogram_pallas"`` for the
histogram-select kernel).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticLM
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import LM
from repro_torch.train import Trainer, TrainConfig


def loss_fn(model: LM, batch: dict):
    return model.loss_and_metrics(batch)


def make_trainer(arch: str = "smollm-135m", *, full: bool = False,
                 steps: int = 200, batch: int = 32, seq_len: int = 32,
                 num_samples: int = 512, strategy: str = "kakurenbo",
                 selection: str = "sort", drop_top: float = 0.0,
                 ckpt_dir: str | None = "results/torch_lm_train_ckpt",
                 device: str | torch.device | None = None, seed: int = 0,
                 model: LM | None = None, lr: float = 1e-2,
                 num_layers: int | None = None, **tc_kw) -> Trainer:
    """The example's ``Trainer``.  ``num_layers`` cuts the depth;
    ``model`` replaces the seeded init (an ``LM`` of the same family, its
    depth may be cut), which draws on the device; ``lr`` is the cosine
    schedule's base (the reference's 1e-2 by default); ``tc_kw`` overrides
    ``TrainConfig``'s fields (the engine, ``scan_steps``,
    ``checkpoint_every``, ...)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if not full:
        cfg = cfg.reduced()
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if cfg.family == "encdec":
        raise ValueError(
            f"{arch}: the encoder-decoder reads frames that SyntheticLM's "
            "batches do not carry (as in the reference's example); train it "
            "on a frames batch source (tests/test_torch_encdec.py::FramesLM)")
    ds = SyntheticLM(num_samples=num_samples, seq_len=seq_len,
                     vocab_size=min(cfg.vocab_size, 64), order=1,
                     easy_fraction=0.7, seed=0)
    epochs = max(steps // (num_samples // batch), 1)
    tc = TrainConfig(**{
        "epochs": epochs, "batch_size": batch, "strategy": strategy,
        "optimizer": "adamw", "optimizer_hp": {},
        "lr": LRSchedule(lr, "cosine", epochs, 1),
        "kakurenbo": KakurenboConfig(
            max_fraction=0.3, selection=selection,
            drop_top_fraction=drop_top,
            fraction_milestones=(0, epochs // 3, epochs // 2,
                                 3 * epochs // 4)),
        "checkpoint_dir": ckpt_dir or None,
        "checkpoint_every": max(epochs // 4, 1), "seed": seed, **tc_kw})
    if model is None:
        model = LM.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
    return Trainer(tc, model, loss_fn, ds, None, device=dev)


def main(argv: list[str] | None = None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--full", action="store_true")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth to this many layers")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2,
                   help="the cosine schedule's base LR (hymba-1.5b at full "
                        "depth stalls at 1e-2 and trains at 1e-3)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--strategy", default="kakurenbo")
    p.add_argument("--selection", default="sort",
                   help="KAKURENBO's selection: sort | histogram | "
                        "histogram_pallas")
    p.add_argument("--ckpt-dir", default="results/torch_lm_train_ckpt",
                   help="checkpoint directory ('' for none)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    args = p.parse_args(argv)

    tr = make_trainer(args.arch, full=args.full, steps=args.steps,
                      batch=args.batch, seq_len=args.seq_len,
                      num_samples=args.num_samples, strategy=args.strategy,
                      selection=args.selection,
                      ckpt_dir=args.ckpt_dir, device=args.device,
                      num_layers=args.layers, lr=args.lr)
    if args.resume and tr.restore_latest():
        print(f"resumed from epoch {tr.epoch}")
    hist = tr.run()
    total_steps = sum(h.bwd_samples for h in hist) // args.batch
    print(f"\narch={tr.model.cfg.name} ({'full' if args.full else 'reduced'}) "
          f"layers={tr.model.cfg.num_layers} "
          f"epochs={tr.cfg.epochs} sgd_steps={total_steps} device={tr.device} "
          f"engine={tr.engine.name}")
    for h in hist:
        print(f"epoch {h.epoch}: loss={h.train_loss:.3f} "
              f"F*={h.hidden_fraction:.3f} lr={h.lr:.4f} "
              f"bwd_samples={h.bwd_samples} wall={h.wall_time:.1f}s")
    return hist


if __name__ == "__main__":
    main()
