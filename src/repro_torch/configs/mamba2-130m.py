"""mamba2-130m [ssm] — pure SSD (state-space duality), attention-free
[arXiv:2405.21060].  d_inner=1536, 24 SSD heads of dim 64, state 128."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", arch_type="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    pattern=("mamba",),
    ssm_state=128,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
