"""Hand-written CUDA kernels (csrc/) and their plain PyTorch versions:

  fed_agg        — staleness-weighted federated aggregation (Eq. 3)
  fed_agg_apply  — fused weighted-sum → pseudo-gradient → server-
                   optimizer moment update → apply (core/merge.py)
"""
from .fed_agg import (APPLY_OPTS, fed_agg, fed_agg_apply,
                      fed_agg_apply_plain, fed_agg_plain, reset_launches)

__all__ = ["APPLY_OPTS", "fed_agg", "fed_agg_apply", "fed_agg_apply_plain",
           "fed_agg_plain", "reset_launches"]
