"""gemma2-2b [dense] — alternating local(4096)/global attention with
attn/final logit soft-capping (50/30) [arXiv:2408.00118]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", arch_type="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    pattern=("local", "attn"),
    window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    long_context_window=4096,
    act="gelu", tie_embeddings=True,
    source="arXiv:2408.00118",
)
