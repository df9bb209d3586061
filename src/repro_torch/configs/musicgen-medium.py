"""musicgen-medium [audio] — decoder-only transformer over EnCodec tokens,
4 codebooks with summed embeddings and per-codebook output heads
[arXiv:2306.05284].  The EnCodec frontend is a stub: input_specs provides
codebook token ids directly (DESIGN.md carve-out)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", arch_type="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    pattern=("attn",),
    n_codebooks=4,
    tie_embeddings=True,        # logits via codebook embeddings
    source="arXiv:2306.05284",
)
