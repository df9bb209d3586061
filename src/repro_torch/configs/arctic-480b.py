"""arctic-480b [moe] — 128-expert top-2 MoE in parallel with a dense
residual FFN (Arctic dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", arch_type="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    pattern=("attn",),
    n_experts=128, top_k=2, parallel_dense_mlp=True,
    tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
