"""Roofline terms of a step, counted by running it once on fake tensors.

The counterpart of the JAX package's launch/hlo_analysis.py.  The JAX dry
run compiles a step for the production mesh and reads XLA's cost and
memory analyses and the partitioned HLO; the port has no compiler and no
SPMD partitioner, so ``count_costs`` runs the step once, on the fake
tensors of launch/specs.py (no data, no allocation), and counts what its
aten ops would do:

- **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``, which counts
  matmul-class ops only (mm, bmm, convolutions, attention), unlike XLA,
  which counts every op.  A hand-written kernel's work is counted through
  its plain version, which is what the wrappers run on a CPU tensor.
- **Bytes accessed**: every aten op's input and output bytes (views,
  allocations and metadata queries excepted).  That is unfused, so it is
  an upper bound of what a fused program moves: an elementwise chain XLA
  fuses reads and writes its intermediates here.
- **Peak live bytes above the arguments**: this module's own live-bytes
  mode, which adds each storage an op creates and subtracts it when the
  storage is freed (not ``MemTracker``).  The arguments, made before the
  step, are not counted; an output written into an argument in place adds
  nothing.

The Python loops of the port's models (layers, token groups, query
chunks) run every iteration on the fake tensors, so the counts need no
correction for loops: the reference's ``loop_aware_costs`` and
``parse_collectives``, which recover the trip counts of ``while`` bodies
from HLO text, have no counterpart.

Per-device terms are the global counts over the mesh's size: an assumption
of even partitioning.  The collective term is derived from the specs
(``param_collectives``): each leaf sharded over the data axes is
all-gathered in the forward, and again in a train step's backward, and
its grad is reduce-scattered; a replicated leaf's grad is all-reduced.
That is a lower bound: the activation collectives of tensor parallelism
are not derived.

``model_flops`` and ``active_param_count`` keep the reference's formulas
(``param_count`` with its caveats: no conv bias, no cross-attention
gates).
"""
from __future__ import annotations

import contextlib
import math
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..sharding.rules import data_axes, leaves_with_path, shard_shape

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W): bf16
# tensor-core FLOP/s, HBM3 bytes/s, NVLink bytes/s in one direction.  The
# same figures as chip_smoke.py's BF16_FLOPS and MEM_BYTES_PER_S.
H100_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_LINK_BYTES_PER_S = 450e9

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# wire-bytes multiplier on the (output) tensor size, ring algorithms,
# n = participants; applied as factor(n) · tensor_bytes
_WIRE_FACTORS = {
    "all-gather": lambda n: (n - 1) / n,           # on output size
    "all-reduce": lambda n: 2 * (n - 1) / n,       # reduce-scatter + gather
    "reduce-scatter": lambda n: (n - 1) / n,       # on input size
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


@dataclass
class CollectiveOp:
    kind: str
    shape_bytes: int
    participants: int
    computation: str
    trip_count: int = 1

    @property
    def wire_bytes(self) -> float:
        return (_WIRE_FACTORS[self.kind](max(2, self.participants))
                * self.shape_bytes * self.trip_count)


def collective_summary(ops: List[CollectiveOp]) -> Dict[str, float]:
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for op in ops:
        out[op.kind] += op.wire_bytes
    out["total_wire_bytes"] = sum(out[k] for k in _COLLECTIVES)
    out["n_ops"] = len(ops)
    return out


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _nbytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def with_specs(tree, specs):
    """``(path, leaf, spec)`` for each leaf of ``tree`` (tensors and host
    scalars), ``specs`` a tree of the same structure with a
    ``PartitionSpec`` at each leaf."""
    spec_of = dict(leaves_with_path(specs))
    for path, leaf in leaves_with_path(tree):
        yield path, leaf, spec_of[path]


def param_collectives(params, specs, mesh, train: bool,
                      batch_over_model: bool = False) -> List[CollectiveOp]:
    """The parameter traffic the specs imply, per device.  A leaf sharded
    over data axes is all-gathered over them before the forward uses it
    (and again in a train step's backward) and its grad reduce-scattered;
    a leaf sharded over none of them has its grad all-reduced over the
    data axes (and 'model' with ``batch_over_model`` when the leaf is not
    model-sharded).  A group of one device moves nothing.  A lower bound:
    no activation collectives."""
    daxes = set(data_axes(mesh))
    ops: List[CollectiveOp] = []
    for path, leaf, spec in with_specs(params, specs):
        name = "/".join(path)
        used = {a for e in spec for a in _axes_of(e)}
        fsdp = used & daxes
        n = math.prod(mesh.shape[a] for a in fsdp)
        if n > 1:
            gathered = tuple(tuple(a for a in _axes_of(e) if a not in daxes)
                             or None for e in spec)
            full = _nbytes(shard_shape(leaf.shape, gathered, mesh),
                           leaf.dtype)
            ops.append(CollectiveOp("all-gather", full, n, name,
                                    2 if train else 1))
            if train:
                ops.append(CollectiveOp("reduce-scatter", full, n, name))
        elif train:
            group = set(daxes)
            if batch_over_model and "model" not in used and \
                    "model" in mesh.shape:
                group.add("model")
            n = math.prod(mesh.shape[a] for a in group)
            if n > 1:
                ops.append(CollectiveOp(
                    "all-reduce",
                    _nbytes(shard_shape(leaf.shape, spec, mesh), leaf.dtype),
                    n, name))
    return ops


# -------------------------------------------------------------- roofline
@dataclass
class Roofline:
    flops: float                 # per-device FLOPs (matmul-class)
    hbm_bytes: float             # per-device bytes accessed (unfused)
    wire_bytes: float            # per-device collective wire bytes
    model_flops: float           # analytic useful flops (global)
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / H100_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / H100_HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.wire_bytes / H100_LINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (chips × per-device counted flops)."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg, shape, n_params_active: int) -> float:
    """Analytic 'useful' flops: 6·N·D train, 2·N·D inference."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch


def active_param_count(cfg) -> int:
    """Params touched per token (MoE: top_k of E experts; a 'moe' block's
    non-gated experts: top_k of E on average over the held ones, each
    held expert touched by a top_k / E share of the tokens)."""
    from ..models.config import param_count
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    expert_params = 3 * cfg.d_model * cfg.d_ff      # per expert, per block
    layer_positions = [i for i, k in enumerate(cfg.pattern)
                       if k != "shared_attn"]
    kinds = [cfg.pattern[layer_positions[li % len(layer_positions)]]
             for li in range(cfg.n_layers)]
    n_moe_blocks = sum(
        1 for li, kind in enumerate(kinds)
        if kind in ("attn", "local", "cross")
        and cfg.use_moe(layer_positions[li % len(layer_positions)]))
    inactive = (cfg.n_experts - cfg.top_k) * expert_params * n_moe_blocks
    held = cfg.n_held
    inactive += (kinds.count("moe") * 2 * cfg.d_model * cfg.d_ff
                 * (held * (cfg.n_experts - cfg.top_k) // cfg.n_experts))
    return total - inactive


# ------------------------------------------------------------ counting
def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# allocations write nothing
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


class _Traffic(TorchDispatchMode):
    """Bytes every aten op reads and writes, and the live bytes of the
    storages the ops create."""

    def __init__(self, known_storages):
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        # held, so no new storage takes one of their ids
        self._known = {id(s): s for s in known_storages}
        self._refs: Dict[int, weakref.ref] = {}

    def _freed(self, key: int, nbytes: int) -> None:
        del self._refs[key]
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        # views move nothing; metadata queries (prim.device) return no
        # tensor
        if outs and not func.is_view and func not in _NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(map(tensor_bytes, ins + outs))
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._known or key in self._refs:
                continue
            nbytes = st.nbytes()
            self._refs[key] = weakref.ref(
                st, lambda _, k=key, n=nbytes: self._freed(k, n))
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return out


def count_costs(fn: Callable, args: tuple) -> Dict[str, Any]:
    """Run ``fn(*args)`` once, under the fake mode of ``args`` if they are
    fake tensors, and count its FLOPs, bytes accessed and peak live bytes
    above the arguments (all global: the whole step on one device).
    Returns the counts, the seconds the run took and the outputs."""
    from torch._guards import detect_fake_mode

    leaves = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    fake = detect_fake_mode(leaves)
    counter = FlopCounterMode(display=False)
    traffic = _Traffic([t.untyped_storage() for t in leaves])
    t0 = time.perf_counter()
    with (fake or contextlib.nullcontext()), counter, traffic:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float(traffic.bytes_accessed),
            "peak_live_bytes": float(traffic.peak),
            "trace_s": trace_s, "outputs": out}


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (a host scalar counts 0)."""
    return sum(tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` laid out by ``specs``."""
    return sum(_nbytes(shard_shape(t.shape, spec, mesh), t.dtype)
               for _, t, spec in with_specs(tree, specs)
               if isinstance(t, torch.Tensor))
