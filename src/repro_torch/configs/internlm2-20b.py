"""internlm2-20b [dense] — plain GQA decoder [arXiv:2403.17297]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", arch_type="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2403.17297",
)
