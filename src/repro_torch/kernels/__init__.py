"""Hand-written CUDA kernels (csrc/) and their plain PyTorch versions:

  fed_agg        — staleness-weighted federated aggregation (Eq. 3)
  fed_agg_apply  — fused weighted-sum → pseudo-gradient → server-
                   optimizer moment update → apply (core/merge.py)
  fed_agg_sharded, — the two with P split over the devices of a mesh
  fed_agg_apply_sharded   (launch/mesh.py); the same kernels per slab
  int8_encode,   — per-chunk int8 quantization of a client update and
  int8_decode      its dense decode (core/compress.py)
  topk_mask      — dense top-k decode given its threshold, driven by
                   topk_encode (core/compress.py)
  flash_attention — causal / sliding-window / soft-capped GQA attention
                   with an online softmax (models/attention.py)
  ssd_scan       — Mamba2 SSD chunked scan with the state carried inside
                   the block, and the final state (models/ssm.py)
  adam           — the local Adam / AdamW step (FedProx term, moments,
                   bias-corrected step, weight decay, apply) over a tree's
                   leaves in one pass (optim/optimizers.py)
"""
from .adam import adam, adam_plain
from .compress import (COMPRESS_SCHEMES, int8_decode, int8_decode_plain, int8_encode,
                       int8_encode_plain, topk_decode, topk_encode, topk_mask,
                       topk_mask_plain, topk_select)
from .fed_agg import (APPLY_OPTS, fed_agg, fed_agg_apply,
                      fed_agg_apply_plain, fed_agg_apply_sharded,
                      fed_agg_plain, fed_agg_sharded)
from .flash_attention import flash_attention, flash_attention_plain
from .ssd_scan import ssd_scan, ssd_scan_plain

KERNELS = (fed_agg, fed_agg_apply, fed_agg_sharded, fed_agg_apply_sharded,
           int8_encode, int8_decode, topk_mask, flash_attention, ssd_scan,
           adam)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for wrapper in KERNELS:
        wrapper.launches = 0


__all__ = ["APPLY_OPTS", "COMPRESS_SCHEMES", "KERNELS", "adam", "adam_plain",
           "fed_agg",
           "fed_agg_apply", "fed_agg_apply_plain", "fed_agg_apply_sharded",
           "fed_agg_plain", "fed_agg_sharded",
           "flash_attention", "flash_attention_plain",
           "int8_decode", "int8_decode_plain", "int8_encode",
           "int8_encode_plain", "reset_launches", "ssd_scan",
           "ssd_scan_plain", "topk_decode",
           "topk_encode", "topk_mask", "topk_mask_plain", "topk_select"]
