"""The hybrid decoder's cell at a tiny size on the CPU: its weights come
from its mix's ``weights_seed`` whatever the run's seed, and its run is
correct; its traced run feeds the host-clock and counter metrics the
cell lists, and no reader of a listed metric raises (the device-trace
readers find no device there).

    python3 -m pytest -q bench_port
"""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import harness, tiny  # noqa: E402
from bench_port.drivers import train_hybrid  # noqa: E402
from bench_port.reference import nemotron_h as ref  # noqa: E402
from bench_port.reference import weights as ref_weights  # noqa: E402

HYBRID = "nemotron3_nano_30b_a3b.train.b4s8192"
SEEDS = (2 ** 31 + 77, 5)


def tiny_hybrid() -> harness.Cell:
    """The hybrid cell at d 64, 4 Mamba heads in 2 groups, 8 router
    experts of which 4 held, its file's first 5 layers, float32."""
    cell = harness.load_cell(HYBRID)
    config = copy.deepcopy(cell.config)
    config.update(hidden_size=64, vocab_size=97, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16,
                  moe_intermediate_size=32,
                  moe_shared_expert_intermediate_size=48,
                  num_experts_per_tok=2, mamba_num_heads=4,
                  mamba_head_dim=16, n_groups=2, ssm_state_size=8,
                  n_routed_experts=4, num_hidden_layers=5)
    config["model"].update(num_hidden_layers=5, n_routed_experts=4,
                           router_experts=8)
    config["precision"]["activations"] = "float32"
    config["params"] = ref_weights.count(
        ref.params(config, torch.Generator().manual_seed(0)))
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(batch=2, seq_len=32, pool_sequences=8)
    return harness.Cell(cell.name, cell.workload, config, traffic,
                        cell.limits, cell.end_to_end, cell.per_layer)


def test_hybrid_weights_come_from_the_mix(monkeypatch):
    cell = tiny_hybrid()
    drawn = []
    make = train_hybrid.make_weights

    def spy(config, seed, device):
        drawn.append(seed)
        return make(config, seed, device)
    monkeypatch.setattr(train_hybrid, "make_weights", spy)
    for seed in SEEDS:
        rec = train_hybrid.run(cell, seed, 0.0, False, device="cpu")
        assert all(c["ok"] for c in rec.checks.values()), rec.checks
    assert drawn == [cell.traffic["weights_seed"]] * 2 * len(SEEDS)


@pytest.mark.parametrize("seed", SEEDS)
def test_hybrid_traced_run_feeds_its_listed_readers(seed):
    cell = tiny_hybrid()
    rec = train_hybrid.run(cell, seed, 0.0, True, device="cpu")
    assert all(c["ok"] for c in rec.checks.values()), rec.checks
    listed = {m["name"]: m["source"] for m in cell.metrics(True)}
    assert "expert_load_max_over_mean.train" in listed
    for name, source in listed.items():
        value = harness.reader(name)(rec)
        if source in ("host_clock", "program_counter"):
            assert value is not None and value > 0, name
