"""Architecture config — one dataclass covers all six assigned arch types.

The per-layer structure is a repeating `pattern` of block kinds:

  'attn'        full-causal self-attention block (attn + mlp)
  'local'       sliding-window self-attention block
  'mamba'       Mamba2 SSD block
  'shared_attn' full-attention block whose params are SHARED across all
                occurrences (Zamba2-style shared transformer block)
  'cross'       self-attention + cross-attention (VLM) block
  'attn_only'   a pre-norm residual block whose one mixer is causal GQA
                self-attention in SDPA, no MLP (Nemotron-H's '*' layers)
  'moe'         a pre-norm residual block whose one mixer is a dropless
                mixture of non-gated experts beside an optional shared
                expert (Nemotron-H's 'E' layers; models/moe.py moe_layer)

Nemotron-H gives its pattern per layer: ``pattern`` is then the whole
stack (``n_layers == len(pattern)``, one superblock), and remat
checkpoints each block of a stack of the single-mixer kinds
(``single_mixer``) on its own; every other stack remats a superblock at
a time.  Every field past the JAX package's (the SSM's heads and
groups, the 'moe' blocks' routed scale, held experts and shared expert,
the chunked CE) defaults to what the JAX package computes, so the configs
both packages hold are the same.

`n_layers` counts pattern-block instances; the stack is
``n_layers // len(pattern)`` scanned superblocks plus an unrolled
remainder of ``n_layers % len(pattern)`` leading pattern positions.
'shared_attn' positions do NOT count toward n_layers (they are extra,
weight-tied injections — Zamba semantics).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default d_model // n_heads

    # --- attention pattern -------------------------------------------------
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 4096                # sliding-window size for 'local'
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0        # chatglm: 0.5 (2d RoPE)
    # long-context adaptation: in long_500k mode, 'attn' blocks become
    # 'local' with this window (0 → arch cannot run long_500k).
    long_context_window: int = 0
    # when > 0, the Zamba2-style shared attention block attends through a
    # sliding window of this size (set by .long_context()).
    shared_attn_window: int = 0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    # per-pattern-position MoE flag (llama4 alternates dense/MoE layers);
    # None → every attention-type block is MoE when n_experts > 0.
    moe_pattern: Optional[Tuple[bool, ...]] = None
    parallel_dense_mlp: bool = False  # llama4 shared expert / arctic dense residual
    capacity_factor: float = 1.25
    moe_group_size: int = 4096        # token-group size for capacity dispatch

    # --- SSM (Mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_n_heads: int = 0              # 0 → expand·d_model / head_dim heads
    ssm_groups: int = 1               # B/C groups (Mamba2 n_groups); the
                                      # gated RMSNorm runs per group

    # --- 'moe' blocks (dropless, sigmoid-routed; models/moe.py moe_layer) ---
    routed_scale: float = 1.0         # the routed weights' scale
    held_experts: int = 0             # experts held here, from the first
                                      # (0 → all n_experts)
    shared_expert_ff: int = 0         # width of the shared expert (0: none)

    # --- VLM -------------------------------------------------------------------
    n_patches: int = 0                # vision-stub patch count

    # --- audio ------------------------------------------------------------------
    n_codebooks: int = 0              # EnCodec codebooks (musicgen: 4)

    # --- misc ---------------------------------------------------------------
    act: str = "silu"                 # silu | gelu | relu2 (relu(x)²)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True                # checkpoint superblocks in train_step
    efficient_ce: bool = False        # logsumexp CE (no fp32 logp tensor)
    ce_chunk: int = 0                 # > 0: the head and logsumexp CE in
                                      # chunks of this many tokens, each
                                      # recomputed in the backward
    attn_fp32_softmax: bool = True    # False → bf16 softmax tensors (the
                                      # Pallas flash kernel's on-chip
                                      # accumulator makes this moot on TPU)
    use_pallas_attention: bool = False  # route full-seq attention through
                                        # kernels/flash_attention (TPU
                                        # target; interpret=True on CPU)
    optimizer: str = "adam"
    learning_rate: float = 3e-4
    source: str = ""                  # citation from the assignment

    # ---------------------------------------------------------------------
    def use_moe(self, pattern_idx: int) -> bool:
        if not self.n_experts:
            return False
        if self.moe_pattern is None:
            return True
        return bool(self.moe_pattern[pattern_idx])

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        if self.ssm_n_heads:
            return self.ssm_n_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_n_heads or self.d_inner // self.ssm_head_dim

    @property
    def single_mixer(self) -> bool:
        """Whether the stack holds the port's single-mixer kinds or grouped
        B/C (Nemotron-H), which serving and the sharded train step do not
        take."""
        return bool({"attn_only", "moe"} & set(self.pattern)) or \
            self.ssm_groups > 1

    @property
    def n_held(self) -> int:
        """Experts a 'moe' block holds here."""
        return self.held_experts or self.n_experts

    @property
    def period(self) -> int:
        # 'shared_attn' occupies a pattern slot but not a layer count
        return sum(1 for k in self.pattern if k != "shared_attn")

    @property
    def n_super(self) -> int:
        return self.n_layers // self.period

    @property
    def n_rem(self) -> int:
        return self.n_layers % self.period

    @property
    def supports_long_context(self) -> bool:
        """True when every block is sub-quadratic at decode time (natively
        windowed/SSM, or adaptable via long_context_window)."""
        for k in self.pattern:
            if k in ("mamba", "local"):
                continue
            if k in ("attn", "shared_attn") and self.long_context_window > 0:
                continue
            return False
        return True

    @property
    def is_decoder(self) -> bool:
        return True  # all assigned archs are decoders (no encoder-only)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: ≤2 layers worth of pattern, d_model ≤ 512,
        ≤4 experts — runnable on CPU in seconds."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_experts = min(self.n_experts, 4) if self.n_experts else 0
        n_kv = min(self.n_kv_heads, n_heads) or n_heads
        while n_heads % n_kv:
            n_kv -= 1
        period = self.period
        # keep one full pattern period (so every block kind is exercised)
        n_layers = period if period > 1 else 2
        return self.replace(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512), head_dim=None,
            n_experts=n_experts,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free dispatch so batched vs single-token routing agree
            # exactly in the smoke tests (full configs keep 1.25)
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            window=min(self.window, 64),
            long_context_window=(min(self.long_context_window, 64)
                                 if self.long_context_window else 0),
            moe_group_size=64, remat=False, dtype="float32",
            **self._reduced_extras(n_experts))

    def _reduced_extras(self, n_experts: int) -> dict:
        """``reduced``'s cuts of the fields the JAX package lacks, only
        where a config sets them (so the shared configs reduce alike)."""
        out = {}
        if self.ssm_n_heads:
            out["ssm_n_heads"] = 4
        if self.ssm_groups > 1:
            out["ssm_groups"] = 2
        if self.held_experts:
            out["held_experts"] = min(self.held_experts, n_experts)
        if self.shared_expert_ff:
            out["shared_expert_ff"] = min(self.shared_expert_ff, 512)
        if self.ce_chunk:
            out["ce_chunk"] = min(self.ce_chunk, 64)
        return out

    def long_context(self) -> "ArchConfig":
        """Variant for long_500k: every full-attention block becomes a
        sliding-window block (DESIGN.md hardware-adaptation note)."""
        if not self.supports_long_context:
            raise ValueError(f"{self.name} cannot run long-context decode")
        w = self.long_context_window or self.window
        pat = tuple(("local" if k == "attn" else k) for k in self.pattern)
        shared_w = w if any(k == "shared_attn" for k in self.pattern) else 0
        return self.replace(pattern=pat, window=w if w else self.window,
                            shared_attn_window=shared_w)


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (for MODEL_FLOPS and sanity checks)."""
    D, F, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.hd
    H, K = cfg.n_heads, cfg.n_kv_heads
    attn = D * H * hd + 2 * D * K * hd + H * hd * D  # q, k, v, o
    mlp = 3 * D * F                                   # gated: wg, wu, wd
    moe = cfg.n_experts * 3 * D * F + D * cfg.n_experts
    if cfg.parallel_dense_mlp:
        moe += mlp
    mamba = 0
    if cfg.ssm_state:
        din, N, Hs = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, \
            cfg.ssm_heads
        conv_dim = din + 2 * N
        in_proj = D * (2 * din + 2 * N + Hs)
        mamba = in_proj + conv_dim * cfg.ssm_conv + 3 * Hs + din + din * D
    norms = 2 * D
    # a 'moe' block: router and its correction bias, the held experts'
    # up and down, the shared expert
    sparse = (D * cfg.n_experts + cfg.n_experts + cfg.n_held * 2 * D * F
              + 2 * D * cfg.shared_expert_ff)
    kinds = {"attn": attn + mlp + norms, "local": attn + mlp + norms,
             "cross": 2 * attn + mlp + 3 * D,
             "mamba": mamba + D,
             "attn_only": attn + D, "moe": sparse + D,
             "shared_attn": 0}
    total = 0
    layer_positions = [i for i, k in enumerate(cfg.pattern)
                       if k != "shared_attn"]
    for li in range(cfg.n_layers):
        i = layer_positions[li % len(layer_positions)]
        kind = cfg.pattern[i]
        total += kinds[kind]
        if kind in ("attn", "local", "cross") and cfg.use_moe(i):
            total += moe - mlp
    if any(k == "shared_attn" for k in cfg.pattern):
        total += attn + mlp + norms  # one shared block
    total += V * D                     # embedding
    if not cfg.tie_embeddings:
        total += D * V * max(1, cfg.n_codebooks or 1)
    if cfg.n_codebooks:
        total += (cfg.n_codebooks - 1) * V * D  # extra codebook embeddings
    total += D  # final norm
    return total


def _pattern_layer_counts(cfg: ArchConfig) -> dict:
    counts: dict = {}
    pat = [k for k in cfg.pattern if k != "shared_attn"]
    for i in range(cfg.n_layers):
        kind = pat[i % len(pat)]
        counts[kind] = counts.get(kind, 0) + 1
    return counts
