"""The port's dry run (launch/specs.py, variants.py, cost_analysis.py,
dryrun.py) against the JAX package's formulas and against real CPU steps.

- ``model_flops`` and ``active_param_count`` equal the reference's for
  every config × input shape; the variants equal the reference's in
  names, overrides and sharding options.
- As tests/test_system.py builds the JAX steps on a host mesh: gemma2-2b,
  mamba2-130m and arctic-480b (reduced) × train / prefill / decode on a
  1 × 1 CPU mesh.  The fake step's argument bytes equal a real CPU
  materialization's, and its FLOPs equal ``FlopCounterMode`` over the real
  CPU step, exactly; its peak live bytes equal the real step's too.
- On the production mesh, per-device argument bytes equal the global
  bytes over each leaf's shard factor.
- The long_500k skip, and one CLI subprocess writing its record.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import hlo_analysis as jax_hlo
from repro.launch.variants import VARIANTS as JAX_VARIANTS
from repro_torch.configs import (INPUT_SHAPES, PORT_ONLY, get_config,
                                 list_architectures)
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import build_step, resolve_config
from repro_torch.launch.variants import VARIANTS

REPO = Path(__file__).resolve().parents[1]

TINY_SHAPES = {
    "train": InputShape("train_tiny", 32, 4, "train"),
    "prefill": InputShape("prefill_tiny", 32, 2, "prefill"),
    "decode": InputShape("decode_tiny", 32, 2, "decode"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU steps gain nothing from intra-op threads, and with one the
    suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", [a for a in list_architectures()
                                  if a not in PORT_ONLY])
def test_formulas_equal_the_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        if name == "long_500k" and cfg.supports_long_context:
            cfg, jcfg = cfg.long_context(), jcfg.long_context()
        n = cost_analysis.active_param_count(cfg)
        assert n == jax_hlo.active_param_count(jcfg)
        assert cost_analysis.model_flops(cfg, shape, n) == \
            jax_hlo.model_flops(jcfg, JAX_SHAPES[name], n)


def test_port_only_configs_count_their_active_params():
    """The configs the JAX package lacks: nemotron-3-nano-30b-a3b touches
    its 6 of 128 relu² experts (2·D·F each) in each of its 23 'moe'
    blocks, everything else on every token."""
    assert PORT_ONLY == ("nemotron-3-nano-30b-a3b",)
    cfg = get_config("nemotron-3-nano-30b-a3b")
    n = cost_analysis.active_param_count(cfg)
    assert n == 31_577_798_976 - 23 * 122 * 2 * 2688 * 1856 == 3_579_935_040
    train = INPUT_SHAPES["train_4k"]
    assert cost_analysis.model_flops(cfg, train, n) == \
        6.0 * n * train.global_batch * train.seq_len


def test_variants_equal_the_reference():
    assert list(VARIANTS) == list(JAX_VARIANTS)
    assert len(VARIANTS) == 20
    for name, v in VARIANTS.items():
        ref = JAX_VARIANTS[name]
        assert v.name == ref.name
        assert v.config_overrides == ref.config_overrides
        assert vars(v.sharding) == vars(ref.sharding)
        assert v.hypothesis
        for figure in ("GB/s", "≈ 0.02", "256 chips", "TPU"):
            assert figure not in v.hypothesis
        cfg = v.apply(get_config("gemma2-2b"))
        for key, value in v.config_overrides.items():
            assert getattr(cfg, key) == value


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m", "arctic-480b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_step_counts_what_the_real_cpu_step_does(arch, kind):
    cfg = get_config(arch).reduced()
    shape = TINY_SHAPES[kind]
    mesh = make_host_mesh(device="cpu")
    record = dryrun.predict(cfg, shape, mesh)
    real = build_step(cfg, shape, mesh, device="cpu")
    assert record["memory_analysis"]["argument_size_in_bytes"] == \
        cost_analysis.tree_bytes(real.args) == \
        record["global"]["argument_bytes"]
    with FlopCounterMode(display=False) as counter:
        real.fn(*real.args)
    assert record["global"]["flops"] == counter.get_total_flops() > 0
    real = build_step(cfg, shape, mesh, device="cpu")
    counted = cost_analysis.count_costs(real.fn, real.args)
    assert record["global"]["peak_live_bytes"] == counted["peak_live_bytes"]
    roof = record["roofline"]
    assert roof["chips"] == 1
    assert roof["compute_s"] == counter.get_total_flops() / 989e12
    assert record["collectives"]["total_wire_bytes"] == 0.0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_production_mesh_bytes_are_global_bytes_over_shard_factors(kind):
    """mamba2-130m at full width cut to 2 layers, 16 sequences (one a
    data shard)."""
    cfg = get_config("mamba2-130m").replace(n_layers=2)
    shape = InputShape(f"{kind}_16", 32, 16, kind)
    mesh = make_production_mesh()
    record = dryrun.predict(cfg, shape, mesh)
    step = build_step(cfg, shape, mesh)
    want, factors = 0.0, set()
    for _, leaf, spec in cost_analysis.with_specs(step.args, step.in_specs):
        if not isinstance(leaf, torch.Tensor):
            continue
        factor = math.prod(mesh.shape[a] for e in spec if e is not None
                           for a in (e if isinstance(e, tuple) else (e,)))
        factors.add(factor)
        assert leaf.shape.numel() % factor == 0
        want += cost_analysis.tensor_bytes(leaf) / factor
    assert factors > {1}                     # some leaf is sharded
    assert record["memory_analysis"]["argument_size_in_bytes"] == want
    assert record["global"]["argument_bytes"] == \
        cost_analysis.tree_bytes(step.args)
    assert record["chips"] == 256
    assert record["roofline"]["flops_per_device"] == \
        record["global"]["flops"] / 256
    coll = record["collectives"]
    assert coll["all-gather"] > 0
    assert (coll["reduce-scatter"] > 0) == (kind == "train")


def test_long_context_pair_is_skipped_for_full_attention():
    record = dryrun.run_pair("chatglm3-6b", "long_500k", "single")
    assert record["status"] == "skipped"
    assert "O(S^2) at 524288 tokens" in record["reason"]
    assert not resolve_config(get_config("zamba2-1.2b"),
                              INPUT_SHAPES["long_500k"]) == get_config(
                                  "zamba2-1.2b")


def test_cli_writes_its_record(tmp_path):
    code = ("import sys; from pathlib import Path; "
            "from repro_torch.launch import dryrun; "
            f"dryrun.RESULTS_DIR = Path({str(tmp_path)!r}); "
            "dryrun.main(sys.argv[1:])")
    out = subprocess.run(
        [sys.executable, "-c", code, "--arch", "mamba2-130m", "--shape",
         "decode_32k", "--mesh", "both"],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert "mamba2-130m decode_32k single [baseline]: OK" in out.stdout
    for mesh, chips in (("single", 256), ("multi", 512)):
        record = json.loads((tmp_path / f"mamba2-130m__decode_32k__{mesh}"
                                         f".json").read_text())
        assert record["status"] == "ok" and record["chips"] == chips
        assert record["roofline"]["dominant"] in ("compute", "memory",
                                                  "collective")
        assert record["memory_analysis"]["argument_size_in_bytes"] > 0
