"""gemma3-1b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt].  26 layers arranged as two scanned superblocks
of 13 (11 local + 2 global each ⇒ 22L/4G total, matching the 5:1 layout
with globals at depth 6/12/19/25).  head_dim 256; local window 512."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    pattern=("local", "local", "local", "local", "local", "attn",
             "local", "local", "local", "local", "local", "attn", "local"),
    window=512, rope_theta=1_000_000.0,
    long_context_window=4096,
    act="gelu", tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
