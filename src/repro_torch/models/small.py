"""The paper's client model architectures (§VI-A2) as pairs of pure
functions.

- MNIST:    2×[conv5x5 + maxpool2x2] → FC(512) → FC(10)
- FEMNIST:  2×[conv5x5 + maxpool2x2] → FC(2048) → FC(62)
- Shakespeare: embed(8) → 2×LSTM(256) → FC(82)
- Speech:   2×[conv3x3, conv3x3, maxpool, dropout(.25)] → avgpool → FC(35)

Params are plain dicts of tensors with the JAX reference's keys, shapes
and layouts (HWIO conv kernels, (in, out) dense weights, LSTM ``wx``
(in, 4h), ``wh`` (h, 4h), ``b`` (4h) in gate order i, f, g, o), and image
inputs are NHWC, so reference params and batches load unchanged.  The
CNNs permute to PyTorch's NCHW inside and back to NHWC before any
flatten, so the rows of ``fc1`` line up with the reference's.  Every
model is plain tensor code, so ``torch.func.vmap`` batches it over
stacked params (fl/executor.py).
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


# ---------------------------------------------------------------- LSTM
def _lstm_init(gen, n_in, hidden, device):
    return {"wx": _normal((n_in, 4 * hidden), math.sqrt(1.0 / n_in), gen,
                          device),
            "wh": _normal((hidden, 4 * hidden), math.sqrt(1.0 / hidden),
                          gen, device),
            "b": torch.zeros(4 * hidden, device=device)}


def _lstm_scan(p, xs):
    """xs: (B, T, n_in) → outputs (B, T, hidden).

    The reference's ``lax.scan`` as a loop over T of plain tensor ops.
    The input projection of every step is one product before the loop
    (the same dot products as the reference's per-step ``x_t @ wx``);
    each step adds ``h @ wh`` and then ``b``, in the reference's order.
    """
    hidden = p["wh"].shape[0]
    B, T = xs.shape[0], xs.shape[1]
    xw = xs @ p["wx"]
    h = torch.zeros(B, hidden, dtype=xs.dtype, device=xs.device)
    c = torch.zeros(B, hidden, dtype=xs.dtype, device=xs.device)
    out = []
    for t in range(T):
        gates = xw[:, t] + h @ p["wh"] + p["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def make_char_lstm(vocab: int = 82, embed: int = 8,
                   hidden: int = 256, name: str = "shakespeare_lstm"
                   ) -> ModelDef:
    """embed(8) → LSTM(256) ×2 → FC(vocab): predict next char from 80 chars."""

    def init(seed: int = 0, device: Optional[torch.device] = None):
        """Draws from a ``torch.Generator`` seeded with ``seed``, with the
        reference's distributions (embedding N(0, 0.01), LSTM weights
        N(0, 1/fan_in), zero biases, He-normal output layer)."""
        gen = torch.Generator().manual_seed(seed)
        device = torch.device("cpu") if device is None else device
        return {
            "embed": _normal((vocab, embed), 0.1, gen, device),
            "lstm1": _lstm_init(gen, embed, hidden, device),
            "lstm2": _lstm_init(gen, hidden, hidden, device),
            "out": _dense_init(gen, hidden, vocab, device),
        }

    def apply(params, tokens):  # (B, T) int → (B, vocab)
        h = params["embed"][tokens]
        h = _lstm_scan(params["lstm1"], h)
        h = _lstm_scan(params["lstm2"], h)
        return _dense(params["out"], h[:, -1, :])

    return ModelDef(init, apply, name)


# ---------------------------------------------------------------- speech
def dropout_plain(h: torch.Tensor, keep: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Inverted dropout on a given keep mask: kept entries scaled by
    1 / (1 - rate), dropped ones 0 — the JAX package's
    ``jnp.where(keep, h / (1 - rate), 0.0)``.  Its gradient is
    ``keep / (1 - rate)``: nothing flows through a dropped entry."""
    return torch.where(keep, h / (1 - rate), 0.0)


def make_speech_cnn(frames: int = 32, mels: int = 32, n_classes: int = 35,
                    name: str = "speech_cnn") -> ModelDef:
    """Paper §VI-A2: two blocks of [conv3x3, conv3x3, maxpool, dropout] →
    average pool → FC(35).  Dropout is inference-scaled: ``apply`` drops
    only when given ``dropout_rng``, a ``torch.Generator`` on the input's
    device (no training path passes one, as in the reference).  After
    each block's max-pool it draws ``keep ~ Bernoulli(1 - rate)`` from
    that generator and applies ``dropout_plain``: at rate 0 the logits
    equal those of ``dropout_rng=None`` bit for bit.  Torch's generator
    cannot reproduce ``jax.random`` draws (and the reference reuses one
    key for both blocks), so the two packages agree on the formula and
    the keep rate, not on the mask."""

    def init(seed: int = 0, device: Optional[torch.device] = None):
        """He-normal kernels and zero biases from a ``torch.Generator``
        seeded with ``seed`` (the reference's distributions)."""
        gen = torch.Generator().manual_seed(seed)
        device = torch.device("cpu") if device is None else device
        return {
            "c1a": _conv_init(gen, 3, 3, 1, 32, device),
            "c1b": _conv_init(gen, 3, 3, 32, 32, device),
            "c2a": _conv_init(gen, 3, 3, 32, 64, device),
            "c2b": _conv_init(gen, 3, 3, 64, 64, device),
            "out": _dense_init(gen, 64, n_classes, device),
        }

    def apply(params, x, *, dropout_rng: Optional[torch.Generator] = None,
              rate: float = 0.25):
        if dropout_rng is not None and not isinstance(dropout_rng,
                                                      torch.Generator):
            raise TypeError(f"dropout_rng must be a torch.Generator on the "
                            f"input's device, not {type(dropout_rng)}")

        def block(h, pa, pb):
            h = F.relu(_conv(pa, h))
            h = F.relu(_conv(pb, h))
            h = F.max_pool2d(h, 2)
            if dropout_rng is not None:
                # drawn in h's memory layout, so the next convolution
                # sees the layout it sees without dropout
                keep = torch.empty_like(h).bernoulli_(
                    1 - rate, generator=dropout_rng).bool()
                h = dropout_plain(h, keep, rate)
            return h

        h = x.permute(0, 3, 1, 2)                    # NHWC → NCHW
        h = block(h, params["c1a"], params["c1b"])
        h = block(h, params["c2a"], params["c2b"])
        h = h.mean(dim=(2, 3))                       # global average pool
        return _dense(params["out"], h)

    return ModelDef(init, apply, name)


SMALL_MODELS = {
    "mnist_cnn": lambda: make_cnn(28, 1, 10, 512, "mnist_cnn"),
    "femnist_cnn": lambda: make_cnn(28, 1, 62, 2048, "femnist_cnn"),
    "shakespeare_lstm": lambda: make_char_lstm(),
    "speech_cnn": lambda: make_speech_cnn(),
}
