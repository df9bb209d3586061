"""Tiny CPU versions of the benchmark's cells, for its tests: the same
files, with the sizes cut so that a run takes seconds on a CPU."""
from __future__ import annotations

import copy

from bench_port import harness

TINY_CNN = {"image_size": 14, "classes": 10, "fc_width": 32,
            "conv_channels": [4, 8]}
TINY_LM = {"d_model": 32, "n_layer": 2, "vocab_size": 64, "d_inner": 64,
           "nheads": 4, "chunk_size": 16,
           "ssm_cfg": {"layer": "Mamba2", "d_state": 8, "d_conv": 4,
                       "expand": 2, "headdim": 16, "ngroups": 1}}


def _params_of(config: dict) -> int:
    import torch

    from bench_port.reference import weights
    gen = torch.Generator().manual_seed(0)
    make = {"cnn": weights.cnn_params, "lm": weights.lm_params}
    return weights.count(make[config["model"]["kind"]](config["model"],
                                                        gen))


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` with a CPU-sized model and traffic (float32
    activations)."""
    cell = harness.load_cell(name)
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    model = config["model"]
    model.update(TINY_CNN if model["kind"] == "cnn" else TINY_LM)
    config["precision"]["activations"] = "float32"
    config["params"] = _params_of(config)
    if traffic["kind"] == "fl":
        traffic.update(clients=8, clients_per_round=4, study_rounds=20)
        traffic["data"]["samples_per_client"] = 12
        if "seq_len" in traffic["data"]:
            traffic["data"]["seq_len"] = 8
        traffic["local"].update(batch_size=4, epochs=1)
        traffic["check"]["clients_per_round_checked"] = 2
    else:
        traffic.update(batch=2, seq_len=32, pool_sequences=8)
    return harness.Cell(cell.name, cell.workload, config, traffic,
                        cell.limits, cell.end_to_end, cell.per_layer)
