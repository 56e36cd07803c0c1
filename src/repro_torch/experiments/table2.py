"""Paper Table 2 on the port: baseline, ISWR, FORGET, SB, KAKURENBO, random
hiding (App. C.4) and InfoBatch, trained on one model and one dataset.

The counterpart of ``benchmarks/common.py::run_strategy`` and
``benchmarks/table2_accuracy.py::main``, with the same settings: the small
paper CNN on ``SyntheticClassification(1024)`` (test split 512), batch 128,
16 epochs, SGD-momentum with cosine LR 0.03 (1 warmup epoch); KAKURENBO
with F = 0.3 and milestones (0, E/3, E/2, 3E/4); FORGET pruning 0.3 after
``max(E // 4, 2)`` warmup epochs; InfoBatch annealing over E epochs.  The
per-sample scores come from ``cnn.per_sample_metrics`` (PA by argmax), as
the reference harness's ``loss_fn`` takes them; ``fused_scoring=True``
scores with the fused pass instead (kernel B1 on the card), whose PA
counts a tied maximum as correct.

    python -m repro_torch.experiments.table2 --device cpu --n 512 --epochs 4

prints one CSV row per strategy, as the reference does:
``table2/<strategy>,<us per epoch>,best_acc=...;diff=...;bwd_samples=...``.
``run_strategy`` takes the model, size, epochs, device and KAKURENBO
config as arguments, so a caller can run the comparison at full width.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import ForgetConfig, KakurenboConfig, LRSchedule
from repro_torch.data import SyntheticClassification
from repro_torch.models.cnn import CNN, CNNConfig, per_sample_metrics
from repro_torch.train import Trainer, TrainConfig

MODEL_CFG = CNNConfig(image_size=16, widths=(16, 32), hidden=64)
NUM_SAMPLES = 1024
NUM_TEST = 512
EPOCHS = 16
BATCH = 128
#: Table 2's rows, baseline first (the others are reported against it).
STRATEGIES = ("baseline", "iswr", "forget", "sb", "kakurenbo", "random",
              "infobatch")


def kakurenbo_config(epochs: int) -> KakurenboConfig:
    """The reference's KAKURENBO setting for an ``epochs``-long run."""
    return KakurenboConfig(max_fraction=0.3,
                           fraction_milestones=(0, epochs // 3, epochs // 2,
                                                3 * epochs // 4))


def _logits_fn(model, batch):
    return model(batch["images"])


def feats_fn(model, batch):
    """``benchmarks/common.py::model_fns``' Grad-Match features, the
    last-layer gradient proxy ``p - onehot(y)`` (softmax probabilities)."""
    logits = model(batch["images"])
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(batch["labels"].long(),
                                         logits.shape[-1]).to(p.dtype)
    return p - onehot


def _loss_fn(model, batch):
    """``benchmarks/common.py::model_fns``' loss: the (weighted) mean CE
    and the per-sample (loss, PA by argmax, PC)."""
    loss, pa, pc = per_sample_metrics(model(batch["images"]), batch["labels"])
    w = batch.get("weight")
    scalar = (loss * w).mean() if w is not None else loss.mean()
    return scalar, (loss, pa, pc)


def make_trainer(strategy: str, *, model_cfg: CNNConfig = MODEL_CFG,
                 n: int = NUM_SAMPLES, n_test: int = NUM_TEST,
                 epochs: int = EPOCHS, seed: int = 0,
                 kakurenbo: KakurenboConfig | None = None,
                 base_lr: float = 0.03, fused_scoring: bool = False,
                 engine: str = "auto",
                 device: str | torch.device | None = None,
                 **tc_kw) -> Trainer:
    """The Table 2 trainer of ``strategy`` (``device=None`` means CUDA),
    on the default engine (``"auto"``: scanned, CUDA graphs on the card) as
    ``benchmarks/common.py::run_strategy`` builds the JAX trainer: with the
    model's class count and Grad-Match's ``feats_fn`` (called only by a
    strategy that asks for features).  ``tc_kw`` sets further
    ``TrainConfig`` fields (checkpoints, the guard)."""
    ds = SyntheticClassification(num_samples=n, image_size=model_cfg.image_size,
                                 seed=seed)
    tc = TrainConfig(
        epochs=epochs, batch_size=BATCH, strategy=strategy,
        fused_scoring=fused_scoring, engine=engine,
        lr=LRSchedule(base_lr, "cosine", epochs, 1),
        kakurenbo=kakurenbo or kakurenbo_config(epochs),
        # FORGET's warmup must fit inside the run so that prune + restart
        # happen: the paper's 20 epochs map to a quarter of the schedule.
        forget=ForgetConfig(fraction=0.3, warmup_epochs=max(epochs // 4, 2)),
        seed=seed, **tc_kw)
    model = CNN(model_cfg, torch.Generator().manual_seed(seed))
    return Trainer(tc, model, _loss_fn, ds, ds.test_split(n_test),
                   logits_fn=_logits_fn, device=device,
                   num_classes=model_cfg.num_classes, feats_fn=feats_fn)


def run_strategy(strategy: str, **kw) -> dict:
    """Train one row of Table 2; returns its history and summary."""
    tr = make_trainer(strategy, **kw)
    t0 = time.perf_counter()
    hist = tr.run()
    wall = time.perf_counter() - t0
    return {"history": hist, "wall_s": wall,
            "final_acc": hist[-1].test_acc,
            "best_acc": max(h.test_acc for h in hist if h.test_acc == h.test_acc),
            "fwd": sum(h.fwd_samples for h in hist),
            "bwd": sum(h.bwd_samples for h in hist)}


def csv_row(name: str, us_per_call: float, derived) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--n", type=int, default=NUM_SAMPLES)
    ap.add_argument("--n-test", type=int, default=NUM_TEST)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    args = ap.parse_args(argv)
    kw = dict(n=args.n, n_test=args.n_test, epochs=args.epochs,
              device=args.device)
    base = run_strategy("baseline", **kw)
    rows = [("table2/baseline", base, 0.0)]
    for strat in STRATEGIES[1:]:
        res = run_strategy(strat, **kw)
        rows.append((f"table2/{strat}", res, res["best_acc"] - base["best_acc"]))
    for name, res, diff in rows:
        print(csv_row(name, res["wall_s"] / args.epochs * 1e6,
                      f"best_acc={res['best_acc']:.4f};diff={diff:+.4f};"
                      f"bwd_samples={res['bwd']}"), flush=True)


if __name__ == "__main__":
    main()
