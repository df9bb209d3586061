"""The benchmark's files against its contract: every name resolves to its
file, names and units are well formed, each per-layer metric's cells
report the metric it moves, the arithmetic of flops.py, and no module
of the benchmark imports JAX, the JAX package, or (in the reference) the
program.

    python3 -m pytest -q bench_port
"""
import ast
import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import flops, harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for path in BENCH["paths"]:
        assert (ROOT / path).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_check_fits_its_time():
    """2 + 14·cells runs of run_seconds + 60 s, 180 s a cell to compile,
    1200 s spare: within 43,200 s at the full 24 cells."""
    cells = 24
    total = ((2 + 14 * cells) * (BENCH["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert (HERE / "drivers" / f"{c.traffic['kind']}.py").is_file()
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.metrics(False) + c.metrics(True):
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert callable(harness.reader(m["name"]))
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in c.metrics(False)}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.metrics(True)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    path = ROOT / config["file"]
    assert path.is_file() and str(path).startswith(str(HERE))
    body = json.loads(path.read_text())
    assert body["name"] == config["name"]
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    for key in config["reduced"]:
        assert not key.endswith(("_dim", "_rank"))


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_reduced_keys_are_in_the_file_with_a_reason(config):
    body = json.loads((ROOT / config["file"]).read_text())
    for key in config["reduced"]:
        assert key in body["model"], key
        assert body["reduced_why"][key].strip(), key


def test_mamba2_params_and_vocab_rows():
    """The published 50,277 ids padded to a multiple of 16 (50,288
    rows), and the file's parameter count worked out from its sizes."""
    from bench_port.reference.weights import vocab_rows
    body = json.loads((HERE / "configs" / "mamba2_130m.json").read_text())
    m = body["model"]
    assert vocab_rows(m) == 50_288
    assert vocab_rows({"vocab_size": 50_277}) == 50_277
    ssm = m["ssm_cfg"]
    d, n, heads, k = m["d_model"], ssm["d_state"], m["nheads"], ssm["d_conv"]
    d_inner = ssm["expand"] * d
    conv = d_inner + 2 * n
    block = (d + d * (2 * d_inner + 2 * n + heads) + conv * k + conv
             + 3 * heads + d_inner + d_inner * d)
    assert vocab_rows(m) * d + m["n_layer"] * block + d == body["params"]
    assert body["params"] == 128_989_632


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    for name in names:
        assert NAME.match(name), name
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_moves_is_reported_where_listed():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in moved, (m["name"], cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


# ------------------------------------------------------------- flops
def test_cnn_forward_flops():
    cnn = json.loads((HERE / "configs" / "femnist_cnn.json").read_text())
    assert flops.cnn_forward_flops(cnn["model"]) == 34_423_808


def test_lm_train_flops():
    assert flops.lm_train_flops(128_983_488, 50_280, 768, 32_768,
                                32_768) == 6 * 128_983_488 * 32_768
    assert flops.lm_train_flops(128_983_488, 50_280, 768, 32_768,
                                32_768) == pytest.approx(2.536e13, rel=1e-3)


def test_fed_agg_bytes():
    assert flops.fed_agg_bytes(64, 6_603_710) == 65 * 6_603_710 * 4


def test_least_time_takes_the_larger_bound():
    t = flops.least_s(3.35e12, 989e12, "sxm", "bf16")
    assert t == pytest.approx(1.0)
    assert flops.least_s(1.0, 2 * 989e12, "sxm", "bf16") == \
        pytest.approx(2.0)


# ------------------------------------------------------------- imports
def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    tops = set(_imports(path))
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert "repro" in harness.loaded_forbidden()
