#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Environment: versions, the card's name and power limit, TF32 off, and
   the CUDA kernels built with nvcc from csrc/ (build seconds printed).
2. Every kernel against its plain PyTorch version on the card, at ragged,
   unaligned and main-path shapes, with the tolerances stated below (the
   compression kernels bit for bit), and timed (CUDA events; device time,
   and as the host issues the calls) beside its memory bound and a
   library yardstick where one PyTorch call computes the same function.
3. The main path: FedLesScan on the full-width FEMNIST CNN (3 rounds,
   8 clients a round, 30 % stragglers), then FedAvg with the FedAdam
   server optimizer, then FedLesScan with int8 and with top-k@1 %
   compressed client updates, through run_experiment on "cuda".  The
   launch counts are set to 0 just before each run and read just after;
   the compressed runs' traces must carry the codec's compression ratio
   in every merge.  Then one client's local training under
   torch.profiler: the card's busy share.
4. A JSON line with every kernel's numbers, then, as the last line,
   {"ok": true, "device": {...}}.

It needs a card: without CUDA, or without the rest of the repository
beside it, it fails before printing any result.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCES = ("fed_agg", "compress")   # csrc/<name>.cu, one nvcc each
MAIN_P = 6_603_710                   # femnist_cnn parameters
MAIN_K = 8                           # clients per round on the main path
MAIN_CHUNK = 256                     # int8 values per scale (the default)
TOPK_RATIO = 0.01                    # top-k@1 % on the main path
CODEC_PS = (1, 255, 257, 4097, MAIN_P)
CODEC_CHUNKS = (8, MAIN_CHUNK)
CODEC_KS = (1, 41, round(MAIN_P * TOPK_RATIO))
FP32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)   # one bf16 ulp
NORM_RTOL = 1e-5
TIMED_RUNS = 20
HOLD_CYCLES = 100_000_000            # ~50 ms of device sleep (see time_ms)
# published peaks of the H100 (SXM / PCIe data sheets)
FP32_FLOPS = {"sxm": 67e12, "pcie": 51e12}
MEM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_part(name: str) -> str:
    return "pcie" if "pcie" in name.lower() else "sxm"


def bound_ms(n_bytes: float, n_flops: float, part: str):
    """Least time for the work: bytes over the memory rate or fp32
    operations over the fp32 peak, whichever is larger."""
    by_bytes = n_bytes / MEM_BYTES_PER_S[part] * 1e3
    by_ops = n_flops / FP32_FLOPS[part] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def time_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3,
            hold: bool = True) -> float:
    """Mean time of one call, by CUDA events around ``runs`` calls.

    With ``hold`` a device-side sleep holds the stream while the host
    queues the calls, so the events time the device work alone, not the
    host's launch overhead (which exceeds a ~10 µs kernel).  Without it
    the calls run as the host issues them: what a caller pays in a loop.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


# ------------------------------------------------------------ phase 1
def phase_environment():
    from repro_torch.kernels import build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = build.build(KERNEL_SOURCES)
    log(f"built {list(KERNEL_SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for name, out in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", out)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", out)]
        log(f"  {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {max(spills)} bytes spilled at most (ptxas)")
    return smi


# ------------------------------------------------------------ phase 2
def _randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def check_fed_agg(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import fed_agg, fed_agg_plain

    main = {}
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for K in (1, 8, 13):
            for P in (1, 4097, MAIN_P):
                u = _randn((K, P), gen, dtype)
                c = torch.rand(K, generator=gen, device="cuda")
                got = fed_agg(u, c)
                want = fed_agg_plain(u, c)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, **tol)
                err = max_abs_err(got, want)
                log(f"fed_agg {str(dtype)[6:]} K={K} P={P}: "
                    f"max |err| {err:.3g}")
                if dtype == torch.float32 and (K, P) == (MAIN_K, MAIN_P):
                    main = dict(u=u, c=c, err=err)
    u, c = main["u"], main["c"]
    K, P = u.shape
    n_bytes = (K + 1) * P * 4 + K * 4
    bound, bound_by = bound_ms(n_bytes, 2.0 * K * P, part)
    row = {
        "name": "fed_agg", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:68",
        "max_abs_err": main["err"],
        "ms": time_ms(lambda: fed_agg(u, c)),
        "call_ms": time_ms(lambda: fed_agg(u, c), hold=False),
        "plain_ms": time_ms(lambda: fed_agg_plain(u, c)),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": time_ms(lambda: torch.matmul(c, u)),
        "shape": f"K={K} P={P} fp32",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def check_fed_agg_apply(gen, part: str) -> dict:
    from repro_torch.kernels.fed_agg import (APPLY_OPTS, fed_agg_apply,
                                             fed_agg_apply_plain)

    hyper = (0.01, 0.8, 0.9, 0.99, 1e-3)         # lr, mix, b1, b2, eps
    main = {}
    for P in (4097, MAIN_P):
        u = _randn((MAIN_K, P), gen)
        c = torch.rand(MAIN_K, generator=gen, device="cuda")
        g = _randn(P, gen)
        m = _randn(P, gen) * 0.1
        v = torch.rand(P, generator=gen, device="cuda") * 0.1
        for opt in APPLY_OPTS:
            got = fed_agg_apply(u, c, g, m, v, *hyper, opt=opt)
            want = fed_agg_apply_plain(u, c, g, m, v, *hyper, opt=opt)
            torch.cuda.synchronize()
            for name, t, w in zip(("out", "m", "v"), got[:3], want[:3]):
                torch.testing.assert_close(t, w, **FP32_TOL,
                                           msg=f"{opt} {name}")
            torch.testing.assert_close(got[3], want[3], rtol=NORM_RTOL,
                                       atol=0.0, msg=f"{opt} norm")
            err = max(max_abs_err(t, w) for t, w in zip(got[:3], want[:3]))
            log(f"fed_agg_apply {opt} K={MAIN_K} P={P}: max |err| "
                f"{err:.3g}, norm {float(got[3]):.6g} vs "
                f"{float(want[3]):.6g}")
            if (opt, P) == ("fedadam", MAIN_P):
                main = dict(args=(u, c, g, m, v), err=err)
    args = main["args"]
    K, P = args[0].shape
    n_bytes = (K + 6) * P * 4 + K * 4
    bound, bound_by = bound_ms(n_bytes, (2.0 * K + 16) * P, part)
    row = {
        "name": "fed_agg_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/fed_agg.cu",
        "replaces": "src/repro/kernels/fed_agg.py:192",
        "max_abs_err": main["err"],
        "ms": time_ms(lambda: fed_agg_apply(*args, *hyper, opt="fedadam")),
        "call_ms": time_ms(
            lambda: fed_agg_apply(*args, *hyper, opt="fedadam"), hold=False),
        "plain_ms": time_ms(
            lambda: fed_agg_apply_plain(*args, *hyper, opt="fedadam")),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,     # no single PyTorch call computes it
        "shape": f"K={K} P={P} fp32 fedadam",
    }
    log(json.dumps({"kernel_check": row}))
    return row


def _codec_inputs(P: int, gen) -> dict:
    """Inputs of the codec checks: random with chunk-to-chunk spread, a
    leading all-zero stretch, a representable grid (integer multiples of
    2^-3 with 127·2^-3 at every 8th place, so every chunk's scale is 2^-3
    and codes and decodes are exact), and a tie-heavy vector (values in
    -3..3, so many |x| share the top-k threshold)."""
    spread = torch.rand(P, generator=gen, device="cuda") * 10
    normal = _randn(P, gen) * spread
    zeros = normal.clone()
    zeros[:min(P, 2 * MAIN_CHUNK)] = 0
    grid = torch.randint(-127, 128, (P,), generator=gen,
                         device="cuda").float() * 2.0 ** -3
    grid[::8] = 127 * 2.0 ** -3
    ties = torch.randint(-3, 4, (P,), generator=gen, device="cuda").float()
    return {"normal": normal, "zero chunk": zeros, "grid": grid,
            "ties": ties}


def check_int8(gen, part: str) -> list:
    from repro_torch.kernels.compress import (int8_decode, int8_decode_plain,
                                              int8_encode, int8_encode_plain)

    errs = {"int8_encode": 0.0, "int8_decode": 0.0}
    for P in CODEC_PS:
        for label, x in _codec_inputs(P, gen).items():
            for chunk in CODEC_CHUNKS:
                q, s = int8_encode(x, chunk)
                q_w, s_w = int8_encode_plain(x, chunk)
                out = int8_decode(q, s, P)
                out_w = int8_decode_plain(q_w, s_w, P)
                torch.cuda.synchronize()
                if not (torch.equal(q, q_w) and torch.equal(s, s_w)):
                    raise RuntimeError(f"int8_encode P={P} chunk={chunk} "
                                       f"{label}: differs from plain")
                if not torch.equal(out, out_w):
                    raise RuntimeError(f"int8_decode P={P} chunk={chunk} "
                                       f"{label}: differs from plain")
                if label == "grid" and not torch.equal(out, x):
                    raise RuntimeError(f"int8 P={P} chunk={chunk}: the "
                                       f"grid does not round-trip")
                enc_err = max(max_abs_err(q, q_w), max_abs_err(s, s_w))
                dec_err = max_abs_err(out, out_w)
                errs["int8_encode"] = max(errs["int8_encode"], enc_err)
                errs["int8_decode"] = max(errs["int8_decode"], dec_err)
            log(f"int8 P={P} {label}: max |err| encode {enc_err:.3g} "
                f"decode {dec_err:.3g} (chunks {CODEC_CHUNKS})")
    P, chunk = MAIN_P, MAIN_CHUNK
    x = _randn(P, gen) * 1e-3
    q, s = int8_encode(x, chunk)
    n_chunks = q.shape[0]
    n_bytes = 4 * P + n_chunks * chunk + 4 * n_chunks
    rows = []
    for name, fn, plain, ops in (
            ("int8_encode", lambda: int8_encode(x, chunk),
             lambda: int8_encode_plain(x, chunk), 6.0 * n_chunks * chunk),
            ("int8_decode", lambda: int8_decode(q, s, P),
             lambda: int8_decode_plain(q, s, P), 1.0 * P)):
        bound, bound_by = bound_ms(n_bytes, ops, part)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/compress.cu",
            "replaces": ("src/repro/kernels/compress.py:67"
                         if name == "int8_encode"
                         else "src/repro/kernels/compress.py:95"),
            "max_abs_err": errs[name],
            "ms": time_ms(fn), "call_ms": time_ms(fn, hold=False),
            "plain_ms": time_ms(plain),
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None,     # no single PyTorch call computes it
            "shape": f"P={P} chunk={chunk} fp32",
        }
        log(json.dumps({"kernel_check": row}))
        rows.append(row)
    return rows


def check_topk_mask(gen, part: str) -> dict:
    from repro_torch.kernels.compress import (topk_decode, topk_encode,
                                              topk_mask, topk_mask_plain,
                                              topk_select)

    err = 0.0
    for P in CODEC_PS:
        for label, x in _codec_inputs(P, gen).items():
            picks = [(k, *topk_select(x, k)) for k in CODEC_KS if k < P]
            if P == 1:       # no k < P: keep and drop the one tie
                tau = x.abs().reshape(())
                picks = [(1, None, tau, torch.tensor(last, device="cuda"))
                         for last in (0, -1)]
            for k, idx, tau, last_keep in picks:
                got = topk_mask(x, tau, last_keep)
                want = topk_mask_plain(x, tau, last_keep)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"topk_mask P={P} k={k} {label}: "
                                       f"differs from plain")
                err = max(err, max_abs_err(got, want))
                if idx is not None:
                    i32, vals, dec = topk_encode(x, k)
                    if not (torch.equal(dec, got) and torch.equal(
                            topk_decode(i32, vals, P), got)
                            and torch.unique(idx).numel() == k):
                        raise RuntimeError(f"topk_encode P={P} k={k} "
                                           f"{label}: decode mismatch")
            log(f"topk_mask P={P} {label}: max |err| {err:.3g} "
                f"(k {[p[0] for p in picks]})")
    P, k = MAIN_P, CODEC_KS[-1]
    x = _randn(P, gen) * 1e-3
    _, tau, last_keep = topk_select(x, k)
    bound, bound_by = bound_ms(8.0 * P, 4.0 * P, part)
    row = {
        "name": "topk_mask", "route": "cuda",
        "source": "src/repro_torch/csrc/compress.cu",
        "replaces": "src/repro/kernels/compress.py:138",
        "max_abs_err": err,
        "ms": time_ms(lambda: topk_mask(x, tau, last_keep)),
        "call_ms": time_ms(lambda: topk_mask(x, tau, last_keep), hold=False),
        "plain_ms": time_ms(lambda: topk_mask_plain(x, tau, last_keep)),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None,         # no single PyTorch call computes it
        # the whole encode: torch.topk, the tie rule, the mask, the gather
        "topk_encode_ms": time_ms(lambda: topk_encode(x, k)),
        "topk_encode_call_ms": time_ms(lambda: topk_encode(x, k),
                                       hold=False),
        "shape": f"P={P} k={k} fp32",
    }
    log(json.dumps({"kernel_check": row}))
    return row


# ------------------------------------------------------------ phase 3
def _train_loss(task, params, parts) -> float:
    """Mean cross-entropy of ``params`` over every client's training
    shard."""
    total, n = 0.0, 0
    for ds in parts.values():
        _, loss = task.evaluate(params, ds)
        total += loss * len(ds)
        n += len(ds)
    return total / n


def _check_ratios(label: str, trace_path: str, ratio) -> None:
    """Every merge of a compressed run carries the codec's ratio of dense
    to wire bytes, rounded as fl/controller.py rounds it."""
    merges = [r for r in map(json.loads, Path(trace_path).read_text()
                             .splitlines())
              if r["type"] == "aggregation" and r["merged"] > 0]
    if not merges:
        raise RuntimeError(f"{label}: no merge in the trace")
    got = {r.get("compression_ratio") for r in merges}
    if got != {ratio}:
        raise RuntimeError(f"{label}: compression ratios {got}, want "
                           f"{ratio}")


def run_main_path(label: str, ratio=None, **overrides) -> dict:
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.fl.experiment import (ExperimentConfig, ScenarioConfig,
                                           run_experiment)
    from repro_torch.kernels import KERNELS, reset_launches
    from repro_torch.launch.train import build_dataset

    task, parts, test_parts = build_dataset("femnist", n_clients=10)
    init = task.init_params(0)
    n_params = sum(t.numel() for t in tree_leaves(init))
    if n_params != MAIN_P:
        raise RuntimeError(f"femnist_cnn has {n_params} params, not {MAIN_P}")
    loss_before = _train_loss(task, init, parts)
    trace_dir = tempfile.TemporaryDirectory()
    trace_path = str(Path(trace_dir.name) / "trace.jsonl")
    cfg = ExperimentConfig(
        n_rounds=3, clients_per_round=MAIN_K, eval_every=3,
        scenario=ScenarioConfig(straggler_fraction=0.3),
        trace_path=trace_path, **overrides)
    # host time inside local training; local_train ends by reading its
    # loss back, so each call's span covers its device work
    spent = {"s": 0.0, "steps": 0}
    local_train = task.local_train

    def timed_local_train(global_params, ds, **kw):
        t = time.perf_counter()
        out = local_train(global_params, ds, **kw)
        spent["s"] += time.perf_counter() - t
        spent["steps"] += task.config.epochs * -(-len(ds)
                                                 // task.config.batch_size)
        return out

    task.local_train = timed_local_train
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    params, res = run_experiment(task, parts, test_parts, cfg,
                                 initial_params=init, device="cuda",
                                 return_params=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    if ratio is not None:
        _check_ratios(label, trace_path, ratio)
    trace_dir.cleanup()
    leaves = tree_leaves(params)
    if not all(t.device.type == "cuda" for t in leaves):
        raise RuntimeError(f"{label}: a param left the card")
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise RuntimeError(f"{label}: non-finite params")
    loss_after = _train_loss(task, params, parts)
    if not loss_after < loss_before:
        raise RuntimeError(f"{label}: training loss did not fall "
                           f"({loss_before:.4f} -> {loss_after:.4f})")
    out = {"run": label, "wall_s": wall, "wall_s_per_round": wall / 3,
           "final_accuracy": res.final_accuracy, "mean_eur": res.mean_eur,
           "virtual_duration_s": res.total_duration_s,
           "train_loss_before": loss_before, "train_loss_after": loss_after,
           "merged_updates": [r.aggregated_updates for r in res.rounds],
           "local_train_s": spent["s"], "local_steps": spent["steps"],
           "ms_per_local_step": 1e3 * spent["s"] / max(1, spent["steps"]),
           "compression_ratio": ratio, "launches": launches}
    log(json.dumps({"main_path": out}))
    return out


def profile_local_training() -> dict:
    """One client's local training (full-width FEMNIST CNN) under
    torch.profiler: how much of a step the card spends in kernels.  The
    profiler adds host time, so the busy share it shows is a lower
    bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import build_dataset

    task, parts, _ = build_dataset("femnist", n_clients=10)
    ds = parts[sorted(parts)[0]]
    params = task.init_params(0)
    task.local_train(params, ds, seed=1)          # warm-up
    steps = task.config.epochs * -(-len(ds) // task.config.batch_size)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.local_train(params, ds, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in on_card)
    by_name = {}
    for e in on_card:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "device_busy_ms_per_step": busy_us / 1e3 / steps,
           "device_busy_share": busy_us / 1e6 / wall,
           "device_ops_per_step": len(on_card) / steps,
           "top_ms_per_step": [[name[:80], us / 1e3 / steps]
                               for name, us in top]}
    log(json.dumps({"local_training_profile": out}))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 1
    smi = phase_environment()
    part = card_part(smi)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_fed_agg(gen, part), check_fed_agg_apply(gen, part),
            *check_int8(gen, part), check_topk_mask(gen, part)]

    fedlesscan = run_main_path("fedlesscan")
    fedadam = run_main_path("fedavg+fedadam", strategy="fedavg",
                            server_opt="fedadam", server_opt_lr=0.01)
    n_chunks = -(-MAIN_P // MAIN_CHUNK)
    int8 = run_main_path(
        "fedlesscan+int8", compress_scheme="int8",
        ratio=round(4 * MAIN_P / (MAIN_P + 4 * n_chunks), 4))
    topk = run_main_path(
        "fedlesscan+topk", compress_scheme="topk",
        compress_topk_ratio=TOPK_RATIO,
        ratio=round(4 * MAIN_P / (8 * CODEC_KS[-1]), 4))
    profile_local_training()
    # which run's launches each kernel's row reports
    runs = {"fed_agg": fedlesscan, "fed_agg_apply": fedadam,
            "int8_encode": int8, "int8_decode": int8, "topk_mask": topk}
    for row in rows:
        run = runs[row["name"]]
        row["launches"] = run["launches"][row["name"]]
        if row["launches"] < 1:
            raise RuntimeError(f"the {run['run']} run never launched "
                               f"{row['name']}")
    if int8["launches"]["int8_encode"] != int8["launches"]["int8_decode"]:
        raise RuntimeError(f"int8 launches differ: {int8['launches']}")
    if int8["launches"]["fed_agg"] < 1 or topk["launches"]["fed_agg"] < 1:
        raise RuntimeError("a compressed run never launched fed_agg")
    for row in rows:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(row[key], float) and math.isfinite(row[key])):
                raise RuntimeError(f"{row['name']}: bad {key} {row[key]}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
