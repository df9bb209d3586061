"""Client-update compression with error feedback (the orchestrator).

The kernels (kernels/compress.py) work on flat vectors; this module owns
the FL semantics around them:

* compression acts on the client's *delta* W_k − w, not the raw weights —
  the server reconstructs W̃_k = w + decode(encode(δ_k)), so every
  downstream merge (Eq. 3 staleness weights, the delta MergePipeline and
  its server optimizers) consumes an ordinary ClientUpdate;
* **error feedback** keeps a per-client residual: the input to the
  encoder is δ_k + r_k and the new residual is what the encoder dropped,
  r_k' = (δ_k + r_k) − decode(·).  Compression error therefore
  telescopes instead of accumulating — the classic EF-SGD guarantee that
  makes aggressive top-k ratios converge;
* residual trees ride the checkpoint array store as the server
  optimizer's moments do (``compress/residual/<cid>`` keys, the
  model-params tree structure, fp32).

Flat vectors follow ``core/flatten.flatten_params`` (``ravel_pytree``
order).  The ``none`` scheme (the default) never touches the update, so
dense runs stay byte-identical; any other scheme always encodes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.compress import (COMPRESS_SCHEMES, int8_decode, int8_encode,
                               topk_encode)
from .flatten import flatten_params, tree_map

Pytree = Any

SCHEMES = COMPRESS_SCHEMES

# simulated wire-format costs (bytes)
_FP32 = 4            # dense value
_TOPK_ENTRY = 8      # int32 index + fp32 value per kept coordinate
_INT8_CODE = 1       # one code byte per parameter
_CHUNK_SCALE = 4     # one fp32 scale per chunk


@dataclass(frozen=True)
class CompressionConfig:
    """Which encoder the client path runs, and how hard it squeezes.

    topk_ratio is the kept fraction (0.01 → top-k@1%, a 50× byte cut at
    8 bytes/entry vs 4 bytes/param dense); chunk is the int8 scale
    granularity (256 params/scale ≈ 1.016 bytes/param on the wire).
    """
    scheme: str = "none"
    topk_ratio: float = 0.01
    chunk: int = 256
    error_feedback: bool = True

    def normalized(self) -> "CompressionConfig":
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown compression scheme {self.scheme!r}; "
                             f"available: {SCHEMES}")
        if self.scheme == "topk" and not (0.0 < self.topk_ratio <= 1.0):
            raise ValueError(f"topk_ratio must be in (0, 1], "
                             f"got {self.topk_ratio}")
        if self.scheme == "int8" and self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        return self

    @property
    def active(self) -> bool:
        """True when encoding runs: any scheme but ``none``."""
        return self.scheme != "none"


class UpdateCompressor:
    """Stateful client-side encoder: per-client error-feedback residuals
    plus the payload-byte arithmetic the simulation bills."""

    def __init__(self, config: Optional[CompressionConfig] = None):
        self.config = (config or CompressionConfig()).normalized()
        # cid -> flat fp32 residual (the coordinates the encoder dropped)
        self._residuals: Dict[str, torch.Tensor] = {}
        self._unflatten32 = None    # cached fp32 unflatten (model layout)
        # (global_params tree, its flat fp32 view) — the global model is
        # one object per round, so K clients share one flatten
        self._flat_g: Optional[Tuple[Pytree, torch.Tensor]] = None

    # ------------------------------------------------------------------
    def _flat_global(self, global_params: Pytree) -> torch.Tensor:
        cached = self._flat_g
        if cached is not None and cached[0] is global_params:
            return cached[1]
        flat_g = flatten_params(global_params)[0].float()
        self._flat_g = (global_params, flat_g)
        return flat_g

    def _ensure_unflatten32(self, global_params: Pytree) -> None:
        if self._unflatten32 is None:
            _, self._unflatten32 = flatten_params(tree_map(
                lambda l: torch.zeros(l.shape, dtype=torch.float32,
                                      device=l.device), global_params))

    def _encode_core(self, client_id: str, flat_u32: torch.Tensor,
                     flat_g: torch.Tensor):
        """Shared EF encode on flat fp32 vectors: returns the decoded
        delta plus the wire-byte arithmetic, updating the residual."""
        P = flat_u32.numel()
        dense_bytes = P * _FP32
        delta = flat_u32 - flat_g
        residual = self._residuals.get(client_id)
        if self.config.error_feedback and residual is not None:
            inp = delta + residual
        else:
            inp = delta

        if self.config.scheme == "topk":
            k = max(1, min(P, int(round(P * self.config.topk_ratio))))
            _, _, decoded = topk_encode(inp, k)
            payload_bytes = k * _TOPK_ENTRY
        else:                                                   # int8
            q, scale = int8_encode(inp, chunk=self.config.chunk)
            decoded = int8_decode(q, scale, P)
            payload_bytes = P * _INT8_CODE + q.shape[0] * _CHUNK_SCALE

        if self.config.error_feedback:
            self._residuals[client_id] = inp - decoded
        return decoded, payload_bytes, dense_bytes

    def _check_size(self, flat_u: torch.Tensor, flat_g: torch.Tensor,
                    what: str) -> None:
        if flat_u.shape != flat_g.shape:
            raise ValueError(
                f"{what} {flat_u.numel()} params, global model flattens "
                f"to {flat_g.numel()} — cannot compress the delta")

    def encode(self, client_id: str, params: Pytree, global_params: Pytree
               ) -> Tuple[Pytree, Optional[int], Optional[int]]:
        """Compress one client update against the round's global model.

        Returns ``(reconstructed_params, payload_bytes, dense_bytes)`` —
        the reconstruction is the server-side decode W̃ = w + decode(δ̃),
        i.e. exactly what a real server would hold after receiving the
        encoded wire payload.  Inactive config → the update passes
        through untouched with (None, None) byte counts.
        """
        if not self.config.active:
            return params, None, None
        flat_u, unflatten = flatten_params(params)
        flat_g = self._flat_global(global_params)
        self._check_size(flat_u, flat_g, "update flattens to")
        decoded, payload_bytes, dense_bytes = self._encode_core(
            client_id, flat_u.float(), flat_g)
        self._ensure_unflatten32(global_params)
        recon = unflatten((flat_g + decoded).to(flat_u.dtype))
        return recon, payload_bytes, dense_bytes

    def encode_flat(self, client_id: str, flat_u: torch.Tensor,
                    global_params: Pytree
                    ) -> Tuple[torch.Tensor, Optional[int], Optional[int]]:
        """``encode`` for one already-flat update row (the vectorized
        executor's layout): no per-client unflatten and re-flatten.

        Returns ``(reconstructed_flat_row, payload_bytes, dense_bytes)``;
        the row is bitwise the flatten of what ``encode`` would return.
        """
        if not self.config.active:
            return flat_u, None, None
        flat_g = self._flat_global(global_params)
        self._check_size(flat_u, flat_g, "update row has")
        decoded, payload_bytes, dense_bytes = self._encode_core(
            client_id, flat_u.float(), flat_g)
        self._ensure_unflatten32(global_params)
        return ((flat_g + decoded).to(flat_u.dtype),
                payload_bytes, dense_bytes)

    # ---- checkpoint surface ------------------------------------------
    def state_dict(self, arrays: Optional[dict] = None) -> dict:
        """Residuals go into `arrays` as model-structured fp32 trees
        (``compress/residual/<cid>``) — the same array-store contract as
        the merge pipeline's server-opt moments."""
        arrays = {} if arrays is None else arrays
        cids = sorted(self._residuals)
        for cid in cids:
            arrays[f"compress/residual/{cid}"] = self._unflatten32(
                self._residuals[cid])
        return {"scheme": self.config.scheme, "clients": cids}

    def load_state_dict(self, state: dict,
                        arrays: Optional[dict] = None) -> None:
        """Missing residual state restores as a fresh encoder (residuals
        re-accumulate from the resume point — same migration contract as
        the server optimizer's moments)."""
        arrays = {} if arrays is None else arrays
        if not state:
            return
        scheme = state.get("scheme")
        if scheme is not None and scheme != self.config.scheme:
            raise ValueError(f"checkpoint was written with compression "
                             f"scheme {scheme!r}, run uses "
                             f"{self.config.scheme!r}")
        self._residuals = {}
        for cid in state.get("clients", []):
            tree = tree_map(lambda l: torch.as_tensor(l, dtype=torch.float32),
                            arrays[f"compress/residual/{cid}"])
            flat, unflatten32 = flatten_params(tree)
            self._residuals[cid] = flat
            if self._unflatten32 is None:
                self._unflatten32 = unflatten32
