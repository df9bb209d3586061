"""Model FLOPs, kernel bytes and operations, and the published peaks.

The only place of the benchmark's roofline and MFU arithmetic.  The
scan's work is a frozen copy of the counting rule that ``chip_smoke.py``
(``_ssd_work``) uses, so later changes there leave this yardstick alone.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 data sheet, dense rates without sparsity, at the 700 W
# (SXM) and 350 W (PCIe) limits; bytes/s of HBM
PEAK_FLOPS = {
    "sxm": {"bf16": 989e12, "tf32": 494.5e12, "fp32": 67e12},
    "pcie": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12},
}
MEM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}


def card_part(name: str) -> str:
    """``pcie`` for a PCIe card by its name, else ``sxm``."""
    return "pcie" if "pcie" in name.lower() else "sxm"


def least_s(n_bytes: float, n_flops: float, part: str,
            precision: str) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak of ``precision``, whichever is larger."""
    return max(n_bytes / MEM_BYTES_PER_S[part],
               n_flops / PEAK_FLOPS[part][precision])


# ------------------------------------------------------------ the CNN
def cnn_forward_flops(model: dict) -> float:
    """Multiply-adds ×2 of one sample's forward: each SAME conv
    (k·k·c_in·c_out per output pixel) at its input's resolution, pools
    halving it, then the two dense layers."""
    size, k = model["image_size"], model["kernel_size"]
    c_in, flops = model["channels"], 0.0
    for c_out in model["conv_channels"]:
        flops += 2.0 * size * size * k * k * c_in * c_out
        size //= model["pool"]
        c_in = c_out
    fc_in = size * size * c_in
    flops += 2.0 * fc_in * model["fc_width"]
    flops += 2.0 * model["fc_width"] * model["classes"]
    return flops


def cnn_train_flops(model: dict, samples: int) -> float:
    """Forward and backward (×3) over ``samples`` real samples."""
    return 3.0 * cnn_forward_flops(model) * samples


# ------------------------------------------------------------ the LM
def lm_train_flops(n_params: int, vocab: int, d_model: int, tokens: int,
                   logit_positions: int) -> float:
    """6·N a token for every parameter but the tied head, which counts
    6·V·D only at the positions whose logits the loss reads (every
    position in training, the last of each sequence in the federated
    next-token task).  The scan's own products and remat's recomputation
    are not counted."""
    head = vocab * d_model
    return 6.0 * (n_params - head) * tokens + 6.0 * head * logit_positions


# ------------------------------------------------------------ kernels
def fed_agg_bytes(k: int, p: int, itemsize: int = 4) -> float:
    """``fed_agg`` over a (K, P) matrix: each row read once and the (P,)
    result written once."""
    return float((k + 1) * p * itemsize)


def fed_agg_flops(k: int, p: int) -> float:
    return 2.0 * k * p


def ssd_work(b: int, l: int, h: int, p: int, n: int, x_itemsize: int = 2,
             bc_heads: int = 1, q: int = 128) -> Tuple[float, float]:
    """(operations, bytes) of one scan call: per token and head 2qn + 2qp
    for the masked products (counted in full, at chunk q) and 4pn for the
    state's two products; x and y, a_dt (fp32), the fp32 final state and
    B and C (each read once, ``bc_heads`` heads of them) moved once."""
    flops = float(b * l * h) * (2 * q * n + 2 * q * p + 4 * p * n)
    n_bytes = (2 * b * l * h * p * x_itemsize + 4 * b * l * h
               + 4 * b * h * p * n + 2 * b * l * bc_heads * n * x_itemsize)
    return flops, float(n_bytes)
