"""Mesh-axis names, the slicing rules of the sharded FL paths, the
large-model sharding rules and their placement (``to_named``: DTensor
placements on a ``DeviceMesh``), and flash decoding over a sharded KV
cache."""
from .flash_decode import reference_decode_attention, sharded_decode_attention
from .rules import (DEFAULT_OPTIONS, PartitionSpec, ShardingOptions,
                    batch_specs, cache_specs, data_axes, logits_spec,
                    opt_specs, param_spec_for, param_specs, shard_shape,
                    to_named)

__all__ = ["DEFAULT_OPTIONS", "PartitionSpec", "ShardingOptions",
           "batch_specs", "cache_specs", "data_axes", "logits_spec",
           "opt_specs", "param_spec_for", "param_specs", "shard_shape",
           "to_named",
           "reference_decode_attention", "sharded_decode_attention"]
