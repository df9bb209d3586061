"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE with a parallel
shared expert on alternating layers (interleaved dense/MoE, Llama-4
design), early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].
24 MoE layers × 128 experts + 24 dense layers ≈ 400B total / 17B active."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    pattern=("attn", "attn"),
    moe_pattern=(False, True),
    n_experts=128, top_k=1, parallel_dense_mlp=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
