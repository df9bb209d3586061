"""Mesh-axis names and the slicing rules of the sharded FL paths, and
flash decoding over a sharded KV cache."""
from .flash_decode import reference_decode_attention, sharded_decode_attention

__all__ = ["reference_decode_attention", "sharded_decode_attention"]
