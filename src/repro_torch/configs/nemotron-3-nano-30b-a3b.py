"""nemotron-3-nano-30b-a3b [hybrid] — NVIDIA Nemotron 3 Nano 30B-A3B
(Nemotron-H), released 2025-12: 52 pre-norm residual blocks of one mixer
each, given per layer by ``hybrid_override_pattern``: 23 Mamba2 mixers (M;
64 heads of 64, d_inner 4096, 8 B/C groups, state 128, conv 4 with bias,
the gated RMSNorm per group of 512), 23 MoE mixers (E; 128 routed relu²
experts of width 1856, top 6 by sigmoid score plus a correction bias,
weights normalised then × 2.5, one shared relu² expert of width 3712,
dropless) and 6 attention mixers (*; 32 query and 2 KV heads of 128, no
positional encoding, no bias).  d 2688, vocab 131,072, untied head,
RMSNorm eps 1e-5; 31.6B parameters, 3.2B active.

The port holds this config alone (the JAX package has no counterpart);
serving and the sharded train step do not take it.  Training at 8192
positions runs the attention in SDPA, the CE in chunks of 4096 tokens and
remat block by block.
"""
from repro_torch.models.config import ArchConfig

# the published hybrid_override_pattern, one letter a layer
PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
KINDS = {"M": "mamba", "E": "moe", "*": "attn_only"}

CONFIG = ArchConfig(
    name="nemotron-3-nano-30b-a3b", arch_type="hybrid",
    n_layers=len(PATTERN), d_model=2688, n_heads=32, n_kv_heads=2,
    head_dim=128, d_ff=1856, vocab=131072,
    pattern=tuple(KINDS[c] for c in PATTERN),
    rope_fraction=0.0,
    n_experts=128, top_k=6, routed_scale=2.5,
    shared_expert_ff=3712,
    ssm_state=128, ssm_head_dim=64, ssm_n_heads=64, ssm_groups=8,
    ssm_conv=4,
    act="relu2", tie_embeddings=False, norm_eps=1e-5,
    efficient_ce=True, ce_chunk=4096,
    source="https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16"
           "/blob/main/config.json",
)
