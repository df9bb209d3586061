"""The paper's client CNN (§VI-A2) as a pair of pure functions.

- MNIST:    2×[conv5x5 + maxpool2x2] → FC(512) → FC(10)
- FEMNIST:  2×[conv5x5 + maxpool2x2] → FC(2048) → FC(62)

Params are plain dicts of tensors with the JAX reference's keys, shapes
and layouts (HWIO conv kernels, (in, out) dense weights), and inputs are
NHWC, so reference params and batches load unchanged.  ``apply`` permutes
to PyTorch's NCHW inside and back to NHWC before the flatten, so the rows
of ``fc1`` line up with the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

Pytree = Any


class ModelDef(NamedTuple):
    init: Callable[..., Pytree]
    apply: Callable[..., torch.Tensor]
    name: str


# ---------------------------------------------------------------- helpers
def _normal(shape, scale: float, gen: torch.Generator,
            device: torch.device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(device)


def _dense_init(gen, n_in, n_out, device):
    return {"w": _normal((n_in, n_out), math.sqrt(2.0 / n_in), gen, device),
            "b": torch.zeros(n_out, device=device)}


def _dense(p, x):
    return x @ p["w"] + p["b"]


def _conv_init(gen, kh, kw, cin, cout, device):
    return {"w": _normal((kh, kw, cin, cout),
                         math.sqrt(2.0 / (kh * kw * cin)), gen, device),
            "b": torch.zeros(cout, device=device)}


def _conv(p, x):
    """NCHW input, HWIO kernel, stride 1, SAME padding (odd kernels)."""
    w = p["w"].permute(3, 2, 0, 1)               # HWIO → OIHW
    return F.conv2d(x, w, p["b"], padding=(w.shape[2] // 2,
                                           w.shape[3] // 2))


# ---------------------------------------------------------------- CNNs
def make_cnn(image_size: int = 28, channels: int = 1, n_classes: int = 10,
             fc_width: int = 512, name: str = "mnist_cnn") -> ModelDef:
    """The paper's LEAF-style 2-layer 5x5 CNN (MNIST: fc=512/10 classes,
    FEMNIST: fc=2048/62 classes)."""
    pooled = image_size // 4  # two 2x2 maxpools

    def init(seed: int = 0, device: Optional[torch.device] = None):
        """He-normal kernels and zero biases, drawn on the CPU from a
        ``torch.Generator`` seeded with ``seed`` (the same distributions
        as the reference; not its numbers)."""
        gen = torch.Generator().manual_seed(seed)
        device = torch.device("cpu") if device is None else device
        return {
            "conv1": _conv_init(gen, 5, 5, channels, 32, device),
            "conv2": _conv_init(gen, 5, 5, 32, 64, device),
            "fc1": _dense_init(gen, pooled * pooled * 64, fc_width, device),
            "out": _dense_init(gen, fc_width, n_classes, device),
        }

    def apply(params, x):
        h = x.permute(0, 3, 1, 2)                    # NHWC → NCHW
        h = F.max_pool2d(F.relu(_conv(params["conv1"], h)), 2)
        h = F.max_pool2d(F.relu(_conv(params["conv2"], h)), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
        h = F.relu(_dense(params["fc1"], h))
        return _dense(params["out"], h)

    return ModelDef(init, apply, name)
