"""What every driver shares: the cell's files found by name, the host
spans, the device record, the judging of ``correct`` and the result line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


# ------------------------------------------------------------- the cell
@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, trace: bool) -> List[dict]:
        """The cell's metrics of one kind: the per-layer ones with
        ``trace``, else the end-to-end ones."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if self.name in m.get("workloads", [self.name])]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its
    configuration, traffic mix and limits, each found by its name."""
    bench = _json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(name, w, _json(root / configs[w["config"]]["file"]),
                _json(HERE / "traffic" / f"{w['traffic']}.json"),
                _json(HERE / "limits" / f"{name}.json"),
                bench["end_to_end"], bench["per_layer"])


def reader(metric: str):
    """``bench_port/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind: str):
    """``bench_port/drivers/<kind>.py``, the driver of a traffic kind."""
    return importlib.import_module(f"bench_port.drivers.{kind}")


# ------------------------------------------------------------- spans
class Spans:
    """Host seconds of named spans; while ``profiling`` each span is also
    a ``record_function`` range ``bench.<name>`` in the trace."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.profiling:
            import torch
            ctx = torch.profiler.record_function(f"bench.{name}")
        t = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t)

    def total(self, name: str) -> float:
        return sum(self.seconds.get(name, ()))

    def wrap(self, name: str, fn):
        def spanned(*args, **kw):
            with self(name):
                return fn(*args, **kw)
        return spanned


# ------------------------------------------------------------- the run
@dataclass
class RunRecord:
    """What a driver hands the metric readers and the result line."""
    cell: Cell
    kind: str
    part: str = "sxm"
    window_s: float = 0.0
    units: int = 0                 # rounds or steps in the window
    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    model_flops: float = 0.0       # over the window
    peak_precision: str = "bf16"
    tokens: int = 0                # over the window (train)
    spans: Spans = field(default_factory=Spans)
    window_span_s: Dict[str, float] = field(default_factory=dict)
    dispatch_s: List[float] = field(default_factory=list)
    group_steps: List[int] = field(default_factory=list)
    trace: Optional[object] = None
    checks: Dict[str, dict] = field(default_factory=dict)
    notes: Dict[str, object] = field(default_factory=dict)
    kept: Optional[object] = None  # what a look at the run reads


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """Each number that has a limit beside it; a number that is missing
    or not finite fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = (limit is not None and value is not None
              and math.isfinite(value) and value <= limit)
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def loaded_forbidden() -> List[str]:
    """Modules of ``FORBIDDEN`` in ``sys.modules``, compared by whole
    top-level name (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def device_record(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def metric_values(run: RunRecord, trace: bool) -> Dict[str, dict]:
    """The cell's metrics as measured: the end-to-end ones from the run,
    the per-layer ones from their readers (a reader that finds nothing
    leaves its metric out)."""
    out = {}
    for m in run.cell.metrics(trace):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def emit(run: RunRecord, trace: bool) -> int:
    """Print the result line (standard output, last) and the compared
    numbers beside their limits (standard error, last); returns the exit
    code."""
    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in the run's process: {bad}",
              file=sys.stderr, flush=True)
        return 3
    checks = run.checks
    correct = bool(checks) and all(c["ok"] for c in checks.values())
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed,
              "metrics": metric_values(run, trace),
              "device": device_record(run.cell.chips, run.peak_bytes)}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    print(json.dumps({"notes": run.notes}), flush=True)
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    return 0
