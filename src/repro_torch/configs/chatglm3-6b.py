"""chatglm3-6b [dense] — GQA kv=2, 2d RoPE (rotary on half the head dim)
[arXiv:2406.12793]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", arch_type="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024,
    pattern=("attn",),
    rope_fraction=0.5,
    tie_embeddings=False,
    source="arXiv:2406.12793",
)
