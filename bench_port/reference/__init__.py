"""The plain reference: plain PyTorch and numpy in float32 with TF32 off.

It imports nothing of the program.  The benchmark makes the weights and
the inputs (``weights.py``, ``bench_port/traffic/generate.py``) and
hands the same to both sides; what the program derives from them, and
its own state, the reference works out again.  ``control`` computes it
in a lower precision (the control): TF32, or ``Quant``, which rounds a
tensor, and its gradient, to bfloat16 or to float8 e4m3 with a
per-tensor scale.
"""
import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matrix products and cuDNN while the block runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def tf32_on():
    """TF32 on for matrix products and cuDNN while the block runs (the
    control of a float32 configuration)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def control(precision: str, device="cuda"):
    """``(context, Quant)`` that compute the reference in a control
    precision: TF32 on (``"tf32"``; on the CPU, which has no TF32, the
    float32 reference with every value and gradient rounded to TF32's 10
    mantissa bits), or values and gradients rounded to ``"bfloat16"`` or
    ``"float8_e4m3"`` inside the float32 reference."""
    if precision == "tf32" and torch.device(device).type == "cuda":
        return tf32_on(), Quant()
    return fp32_exact(), Quant(precision)


_FP8_MAX = 448.0


def _round(t: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "tf32":
        # float32 rounded to TF32's 10 mantissa bits (half up)
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32).to(t.dtype)
    if dtype == "bfloat16":
        return t.to(torch.bfloat16).to(t.dtype)
    if dtype == "float8_e4m3":
        scale = t.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale
    raise ValueError(f"unknown control precision {dtype!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return _round(t, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Quant:
    """``q(t)``: ``t`` as it would be held in ``dtype`` (None: as it is),
    forward and backward."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.dtype is None else _Round.apply(t, self.dtype)
