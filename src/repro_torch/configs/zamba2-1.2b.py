"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared full-attention block
applied every 6 SSM layers (weight-tied, Zamba design) [arXiv:2411.15242].
38 Mamba2 layers; 6 shared-attn injections (38//6) + 2 trailing SSM layers.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba",
             "shared_attn"),
    ssm_state=64,
    long_context_window=4096,   # shared attn switches to window at 500k
    tie_embeddings=True,
    source="arXiv:2411.15242",
)
