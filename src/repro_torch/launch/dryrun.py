"""Dry run: count every (architecture × input shape) on the production
meshes, on fake tensors, and record memory, cost and roofline terms.

The port of the JAX package's launch/dryrun.py.  The step of a pair
(launch/specs.py) runs once on fake tensors on the CPU (no card, no
allocation) under launch/cost_analysis.py's counters; its args' specs
(sharding/rules.py) give the bytes each device holds.  The terms take the
H100's peaks (cost_analysis.H100_*) for a mesh of H100s that nobody ran:
they are predictions.  It counts the reference's default config
(``use_pallas_attention`` False), as the JAX dry run does.

One pair per invocation; ``--all`` drives the sweep, one subprocess a
pair, and skips pairs already recorded (``--force`` redoes them).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

LONG_CONTEXT_SKIP = ("full-attention arch; O(S^2) at 524288 tokens "
                     "excluded by assignment rule (DESIGN.md)")


def predict(cfg, shape, mesh, opts=None) -> dict:
    """Build the pair's step on fake tensors, run it once, and return the
    record's measurements: per-device argument, output and temp bytes,
    the counts, the derived collectives and the roofline."""
    from ..sharding.rules import DEFAULT_OPTIONS
    from .cost_analysis import (Roofline, active_param_count,
                                collective_summary, count_costs, model_flops,
                                param_collectives, per_device_bytes,
                                tree_bytes)
    from .specs import build_step, resolve_config

    opts = opts or DEFAULT_OPTIONS
    chips = mesh.size
    t0 = time.perf_counter()
    step = build_step(cfg, shape, mesh, opts)
    build_s = time.perf_counter() - t0
    costs = count_costs(step.fn, step.args)
    out = costs.pop("outputs")
    out_specs = step.out_specs(out)
    arg_bytes = per_device_bytes(step.args, step.in_specs, mesh)
    out_bytes = per_device_bytes(out, out_specs, mesh)
    params = step.args[0]["params"] if shape.kind == "train" else \
        step.args[0]
    p_specs = step.in_specs[0]["params"] if shape.kind == "train" else \
        step.in_specs[0]
    ops = param_collectives(params, p_specs, mesh, shape.kind == "train",
                            opts.batch_over_model)
    coll = collective_summary(ops)
    rcfg = resolve_config(cfg, shape)
    n_active = active_param_count(rcfg)
    roof = Roofline(flops=costs["flops"] / chips,
                    hbm_bytes=costs["bytes_accessed"] / chips,
                    wire_bytes=coll["total_wire_bytes"],
                    model_flops=model_flops(rcfg, shape, n_active),
                    chips=chips)
    return {
        "chips": chips,
        "build_s": round(build_s, 1), "trace_s": round(costs["trace_s"], 1),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": costs["peak_live_bytes"] / chips,
            "note": "argument and output bytes from the specs; temp: peak "
                    "live bytes above the arguments over the mesh size "
                    "(even partitioning assumed)"},
        "global": {"argument_bytes": tree_bytes(step.args),
                   "output_bytes": tree_bytes(out),
                   "peak_live_bytes": costs["peak_live_bytes"],
                   "flops": costs["flops"],
                   "bytes_accessed": costs["bytes_accessed"]},
        "cost_analysis": {
            "flops": costs["flops"], "bytes_accessed": costs["bytes_accessed"],
            "note": "FlopCounterMode (matmul-class ops); bytes: every aten "
                    "op's inputs and outputs, unfused (an upper bound)"},
        "collectives": dict(coll, note="parameter traffic the specs imply: "
                                       "a lower bound, no activation "
                                       "collectives"),
        "active_params": n_active,
        "roofline": roof.as_dict(),
    }


def run_pair(arch_id: str, shape_name: str, mesh_kind: str,
             variant_name: str = "baseline") -> dict:
    from ..configs import INPUT_SHAPES, get_config
    from .mesh import make_production_mesh
    from .variants import VARIANTS

    variant = VARIANTS[variant_name]
    cfg = variant.apply(get_config(arch_id))
    shape = INPUT_SHAPES[shape_name]
    record: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                    "kind": shape.kind, "variant": variant_name,
                    "hypothesis": variant.hypothesis}

    if shape.name == "long_500k" and not cfg.supports_long_context:
        record.update(status="skipped", reason=LONG_CONTEXT_SKIP)
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    record.update(status="ok", **predict(cfg, shape, mesh, variant.sharding))
    return record


def result_path(arch: str, shape: str, mesh: str,
                variant: str = "baseline") -> Path:
    suffix = "" if variant == "baseline" else f"__{variant}"
    return RESULTS_DIR / f"{arch}__{shape}__{mesh}{suffix}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="baseline",
                    help="named variant (launch/variants.py)")
    ap.add_argument("--all", action="store_true",
                    help="drive the full sweep via subprocesses")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)

    if args.all:
        from ..configs import INPUT_SHAPES, list_architectures
        meshes = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
        pairs = [(a, s, m) for a in list_architectures()
                 for s in INPUT_SHAPES for m in meshes]
        for arch, shape, mesh in pairs:
            out = result_path(arch, shape, mesh, args.variant)
            if out.exists() and not args.force:
                print(f"skip (cached): {arch} {shape} {mesh}")
                continue
            print(f"== {arch} × {shape} × {mesh} ==", flush=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--variant", args.variant]
            try:
                rc = subprocess.run(cmd, timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "timeout", "timeout_s": args.timeout}))
                print("   TIMEOUT")
                continue
            if rc != 0 and not out.exists():
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "status": "crashed", "returncode": rc}))
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mesh_kind in meshes:
        out = result_path(args.arch, args.shape, mesh_kind, args.variant)
        try:
            record = run_pair(args.arch, args.shape, mesh_kind,
                              args.variant)
        except Exception as e:  # record the failure: it is a bug to fix
            record = {"arch": args.arch, "shape": args.shape,
                      "mesh": mesh_kind, "variant": args.variant,
                      "status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}
        out.write_text(json.dumps(record, indent=1))
        status = record.get("status")
        if status == "ok":
            r = record["roofline"]
            print(f"{args.arch} {args.shape} {mesh_kind} "
                  f"[{args.variant}]: OK "
                  f"compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s "
                  f"collective={r['collective_s']:.3e}s "
                  f"dominant={r['dominant']} "
                  f"useful={r['useful_flops_ratio']:.2f} "
                  f"(build {record['build_s']}s, trace {record['trace_s']}s)")
            print("  memory_analysis:", json.dumps(record["memory_analysis"]))
            print("  collectives:", json.dumps(record["collectives"]))
        else:
            print(f"{args.arch} {args.shape} {mesh_kind}: {status}: "
                  f"{record.get('reason', record.get('error', ''))}")
            if record.get("traceback"):
                print(record["traceback"][-1500:])


if __name__ == "__main__":
    main()
