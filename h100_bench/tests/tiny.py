"""Cells of ``BENCHMARK.json`` at CPU-test sizes: every width and the
shapes cut, the traffic and checks as they are."""
import dataclasses

from h100_bench import cells

TINY_ARCH = {
    "ssm": dict(num_layers=2, d_model=64, vocab_size=96,
                ssm={"state_dim": 16, "head_dim": 16, "expand": 2,
                     "conv_width": 4, "chunk": 16}),
    "dense": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=96),
}
TINY_SHAPE = {"batch": 4, "seq_len": 32, "num_samples": 32}


def tiny(name: str) -> cells.Cell:
    c = cells.load(name)
    cfg = dict(c.config)
    cfg["arch"] = {**cfg["arch"], **TINY_ARCH[cfg["arch"]["family"]]}
    cfg["train_shape"] = dict(TINY_SHAPE)
    return dataclasses.replace(c, config=cfg)


def workloads() -> list[str]:
    return [w["name"] for w in cells.benchmark()["workloads"]]
