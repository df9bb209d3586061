"""Named variants of the dry run: bundles of config and sharding changes.

The port of the JAX package's launch/variants.py: the same names,
config overrides and ``ShardingOptions``.  Each variant states its
hypothesis as a mechanism; the dry run (launch/dryrun.py) counts the
same (arch × shape) under the variant, and the roofline terms' change
confirms or refutes it.  ``baseline`` is the configuration every pair is
first recorded with.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from ..models.config import ArchConfig
from ..sharding.rules import ShardingOptions


@dataclass(frozen=True)
class Variant:
    name: str
    hypothesis: str
    config_overrides: Dict = field(default_factory=dict)
    sharding: ShardingOptions = ShardingOptions()

    def apply(self, cfg: ArchConfig) -> ArchConfig:
        return cfg.replace(**self.config_overrides) if \
            self.config_overrides else cfg


VARIANTS: Dict[str, Variant] = {v.name: v for v in [
    Variant(
        "baseline",
        "the reference's defaults: fp32 master params, remat on, FSDP+TP "
        "sharding, log-softmax CE"),
    Variant(
        "bf16-params",
        "bf16 param storage halves every param collective (FSDP gathers, "
        "grad reductions) and the param reads; Adam m/v stay fp32, so the "
        "collective term halves on pairs whose traffic is params",
        config_overrides=dict(param_dtype="bfloat16")),
    Variant(
        "no-remat",
        "remat recomputes the forward inside the backward, about a third "
        "more FLOPs and bytes; turning it off trades live activations for "
        "both terms on pairs that fit without checkpointing",
        config_overrides=dict(remat=False)),
    Variant(
        "efficient-ce",
        "the logsumexp CE does not materialise the fp32 log-softmax tensor "
        "(B·S·V); on a large vocabulary that tensor is the loss's largest "
        "memory consumer, so the memory term falls on big-vocab pairs",
        config_overrides=dict(efficient_ce=True)),
    Variant(
        "attn-replicate",
        "archs with fewer heads than the model axis shard head_dim, which "
        "forces a reshard of attention every layer; replicating the "
        "attention weights over 'model' keeps attention local to each data "
        "shard and removes those collectives",
        sharding=ShardingOptions(attn_model=False)),
    Variant(
        "dp-only",
        "a model whose optimizer state fits on one device gains nothing "
        "from tensor parallelism, so every model-axis collective is "
        "overhead; pure data parallelism over the whole mesh leaves the "
        "gradient all-reduce, grads·2(n−1)/n over the link rate",
        sharding=ShardingOptions(use_model_axis=False,
                                 batch_over_model=True)),
    Variant(
        "opt-combo",
        "bf16 params + efficient CE + attention replication together "
        "(the per-pair winning moves composed)",
        config_overrides=dict(param_dtype="bfloat16", efficient_ce=True),
        sharding=ShardingOptions(attn_model=False)),
    Variant(
        "dp-bf16",
        "pure DP + bf16 params: the grad all-reduce also halves",
        config_overrides=dict(param_dtype="bfloat16"),
        sharding=ShardingOptions(use_model_axis=False,
                                 batch_over_model=True)),
    Variant(
        "bf16-ce",
        "bf16 params + logsumexp CE (no attention-sharding change)",
        config_overrides=dict(param_dtype="bfloat16", efficient_ce=True)),
    Variant(
        "moe-small-group",
        "one-hot MoE dispatch costs 2·T·g·k·cf·D FLOPs and bytes, linear "
        "in the group size g, while the expert matmuls do not depend on "
        "g; a quarter of the group size should cut the dispatch FLOPs and "
        "bytes about fourfold on MoE pairs",
        config_overrides=dict(moe_group_size=1024)),
    Variant(
        "moe-small-group-bf16-ce",
        "compose the MoE dispatch shrink with bf16 params + logsumexp CE",
        config_overrides=dict(moe_group_size=1024,
                              param_dtype="bfloat16", efficient_ce=True)),
    Variant(
        "no-remat-bf16-ce",
        "remat off + bf16 params + logsumexp CE: trade live activations "
        "for the recomputed forward's bytes and FLOPs",
        config_overrides=dict(remat=False, param_dtype="bfloat16",
                              efficient_ce=True)),
    Variant(
        "dp-replicated",
        "FSDP-sharding params over 'data' while the batch also uses "
        "'data' forces reshards; true pure DP replicates the params of a "
        "model whose params and Adam state fit on one device and shards "
        "the batch over the whole mesh, so the only collective left is "
        "the gradient all-reduce",
        sharding=ShardingOptions(replicate_params=True,
                                 batch_over_model=True)),
    Variant(
        "dp-replicated-bf16",
        "pure replicated DP + bf16 params (halves the grad all-reduce)",
        config_overrides=dict(param_dtype="bfloat16"),
        sharding=ShardingOptions(replicate_params=True,
                                 batch_over_model=True)),
    Variant(
        "moe-big-group",
        "the expert weights are read again for every token group: weight "
        "reads scale as T/g while the dispatch tensor scales as g, so a "
        "larger group re-reads the experts fewer times and, while the "
        "dispatch stays the smaller term, lowers the memory term",
        config_overrides=dict(moe_group_size=32768)),
    Variant(
        "moe-big-group-bf16-ce",
        "compose the group-size change with bf16 params (halves the "
        "weight stream again) + logsumexp CE",
        config_overrides=dict(moe_group_size=32768,
                              param_dtype="bfloat16", efficient_ce=True)),
    Variant(
        "bf16-softmax",
        "the plain attention's fp32 softmax tensors (B,K,G,Sq,Sk) move "
        "most of the bytes when the heads do not divide the model axis; "
        "a bf16 softmax halves that traffic (the flash kernel never "
        "writes it)",
        config_overrides=dict(attn_fp32_softmax=False)),
    Variant(
        "bf16-softmax-ce",
        "bf16 softmax + bf16 params + logsumexp CE composed",
        config_overrides=dict(attn_fp32_softmax=False,
                              param_dtype="bfloat16", efficient_ce=True)),
    Variant(
        "dp-replicated-best",
        "replicated pure DP + bf16 params + no remat + logsumexp CE: the "
        "small-model configuration fully composed (remat off removes the "
        "recomputed forward's bytes on top of the DP change)",
        config_overrides=dict(param_dtype="bfloat16", remat=False,
                              efficient_ce=True),
        sharding=ShardingOptions(replicate_params=True,
                                 batch_over_model=True)),
    Variant(
        "arctic-best",
        "compose the arctic changes: no remat + bf16 softmax + bf16 "
        "params + logsumexp CE",
        config_overrides=dict(remat=False, param_dtype="bfloat16",
                              efficient_ce=True, attn_fp32_softmax=False)),
]}
