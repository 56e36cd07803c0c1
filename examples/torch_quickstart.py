"""Quickstart on the PyTorch port: KAKURENBO vs the baseline.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --full --epochs 3

The counterpart of ``examples/quickstart.py``: trains the paper's model
family on the synthetic easy/hard dataset twice, uniform baseline and
KAKURENBO, and prints the accuracy and backward-work comparison.  It runs
on CUDA unless ``--device cpu`` is given, through the default epoch engine
(the dataset on the device, each block of steps one CUDA graph replay).
``--full`` takes the main path's settings instead of the small ones: the
paper CNN (``configs/paper_cnn.py``) on ``SyntheticClassification(50_000)``,
KAKURENBO selecting by the histogram-select kernel with DropTop 0.02 and
scoring with the fused pass (kernel B1).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.paper_cnn import CONFIG as PAPER_CNN
from repro_torch.core import KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models import cnn
from repro_torch.train import Trainer, TrainConfig

SMALL = cnn.CNNConfig(image_size=16, widths=(16, 32), hidden=64)


def logits_fn(model, batch):
    return model(batch["images"])


def loss_fn(model, batch):
    loss, pa, pc = cnn.per_sample_metrics(model(batch["images"]),
                                          batch["labels"])
    w = batch.get("weight")
    scalar = (loss * w).mean() if w is not None else loss.mean()
    return scalar, (loss, pa, pc)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--full", action="store_true",
                    help="the main path: paper CNN, 50,000 samples, "
                         "histogram-select + DropTop 0.02, fused scoring")
    ap.add_argument("--epochs", type=int, default=None)
    args = ap.parse_args(argv)
    if args.full:
        model_cfg, n, n_test, epochs = PAPER_CNN, 50_000, 10_000, args.epochs or 3
        kc = KakurenboConfig(max_fraction=0.3, selection="histogram_pallas",
                             drop_top_fraction=0.02)
    else:
        model_cfg, n, n_test, epochs = SMALL, 1024, 512, args.epochs or 12
        kc = KakurenboConfig(max_fraction=0.3,
                             fraction_milestones=(0, 4, 6, 9))
    ds = SyntheticClassification(num_samples=n, seed=0)
    test = ds.test_split(n_test)
    results = {}
    for strategy in ("baseline", "kakurenbo"):
        tc = TrainConfig(
            epochs=epochs, batch_size=128, strategy=strategy,
            lr=LRSchedule(0.05, "cosine", epochs, 1), kakurenbo=kc,
            fused_scoring=args.full)
        model = cnn.CNN(model_cfg, torch.Generator().manual_seed(0))
        tr = Trainer(tc, model, None if args.full else loss_fn, ds, test,
                     logits_fn=logits_fn, device=args.device)
        hist = tr.run()
        results[strategy] = (hist[-1].test_acc,
                             sum(h.bwd_samples for h in hist),
                             sum(h.wall_time for h in hist))
        print(f"[{strategy}] {tr.device} engine={tr.engine.name} per-epoch: "
              + " ".join(f"e{h.epoch}:acc={h.test_acc:.2f},"
                         f"F*={h.hidden_fraction:.2f},{h.wall_time:.2f}s"
                         for h in hist))
    (acc_b, bwd_b, t_b), (acc_k, bwd_k, t_k) = (results["baseline"],
                                                results["kakurenbo"])
    print(f"\nbaseline : acc={acc_b:.3f}  bwd_samples={bwd_b}  wall={t_b:.1f}s")
    print(f"kakurenbo: acc={acc_k:.3f}  bwd_samples={bwd_k}  wall={t_k:.1f}s")
    print(f"backward work saved: {1 - bwd_k / bwd_b:.1%}  "
          f"accuracy delta: {acc_k - acc_b:+.3f}")


if __name__ == "__main__":
    main()
