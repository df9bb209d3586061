"""llama-3.2-vision-11b [vlm] — 40-layer text decoder with gated
cross-attention blocks every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision].
The ViT vision encoder + projector is a stub: input_specs provides
precomputed patch embeddings (B, 1024, d_model) (DESIGN.md carve-out)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", arch_type="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=500_000.0,
    n_patches=1024,
    tie_embeddings=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
