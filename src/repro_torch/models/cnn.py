"""Small conv classifier — the paper's own model family.

Port of ``repro/models/cnn.py``.  The public layout is the JAX package's:
images enter as (B, H, W, C).  Inside, convolutions run in PyTorch's NCHW;
before ``fc1`` the activations are permuted back to NHWC so the flattened
feature order — and with it the rows of ``fc1`` — matches the reference.
Conv layers use SAME padding (3x3, stride 1: one pixel), max-pool is 2x2
VALID.  PA is top-1 correctness and PC the max softmax probability (Eq. 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper_cifar_cnn"
    image_size: int = 16
    channels: int = 3
    widths: tuple[int, ...] = (32, 64)
    num_classes: int = 10
    hidden: int = 128

    @property
    def features(self) -> int:
        return (self.image_size // (2 ** len(self.widths))) ** 2 * self.widths[-1]


class CNN(nn.Module):
    """conv3x3 -> ReLU -> maxpool2x2 per width, then fc1 -> ReLU -> fc2.

    Initialised like the reference (He-normal convs, 1/sqrt(fan_in) normal
    linears, zero biases) from ``generator``; the numbers differ from
    jax.random's, so parity tests load the reference's params with
    ``params_from_jax``.
    """

    def __init__(self, cfg: CNNConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        convs, cin = [], cfg.channels
        for w in cfg.widths:
            convs.append(nn.Conv2d(cin, w, 3, padding=1))
            cin = w
        self.convs = nn.ModuleList(convs)
        self.fc1 = nn.Linear(cfg.features, cfg.hidden)
        self.fc2 = nn.Linear(cfg.hidden, cfg.num_classes)
        with torch.no_grad():
            for conv in self.convs:
                fan_in = 9 * conv.in_channels
                conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
                conv.bias.zero_()
            for fc in (self.fc1, self.fc2):
                fc.weight.normal_(0.0, (1.0 / fc.in_features) ** 0.5,
                                  generator=generator)
                fc.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B, num_classes)."""
        x = images.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.fc2(F.relu(self.fc1(x)))


def per_sample_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """(loss, PA, PC) per sample — paper Eq. 3; PA by argmax."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(1, labels.long()[:, None])[:, 0]
    loss = lse - gold
    pa = lf.argmax(dim=-1) == labels
    pc = torch.exp(lf.amax(dim=-1) - lse)
    return loss, pa, pc


def params_from_jax(np_params: dict, cfg: CNNConfig) -> dict[str, torch.Tensor]:
    """A ``CNN`` state dict from the JAX model's params (numpy arrays):
    conv HWIO -> OIHW, ``fc*`` (in, out) -> torch's (out, in)."""
    sd = {}
    for i in range(len(cfg.widths)):
        sd[f"convs.{i}.weight"] = np.transpose(np_params[f"conv{i}"], (3, 2, 0, 1))
        sd[f"convs.{i}.bias"] = np_params[f"convb{i}"]
    for name in ("fc1", "fc2"):
        sd[f"{name}.weight"] = np.transpose(np_params[name])
        sd[f"{name}.bias"] = np_params[f"{name}b"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}
