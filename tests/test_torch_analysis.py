"""repro-lint for the port (repro_torch.analysis): every rule fires on the
fixture corpus at its expected location, pragmas and the baseline
round-trip, ``src/repro_torch`` is clean with an empty baseline, and the
rules shared with the JAX package (DET001–DET004, CON002) give exactly
``repro.analysis``'s findings on that package's own corpus, with the same
fingerprints and baselines that load in either package."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import baseline as ref_baseline
from repro.analysis import core as ref_core
from repro.analysis.rules import select_rules as ref_select_rules
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import (FileContext, line_fingerprint,
                                       load_project, run_rules)
from repro_torch.analysis.rules import ALL_RULES, select_rules
from repro_torch.analysis.rules.contracts import plain_name
from repro_torch.analysis.rules.torch_safety import UndeclaredMeshAxisRule

HERE = Path(__file__).resolve().parent
FIXTURES = HERE / "torch_analysis_fixtures"
FIXTURE_TESTS = FIXTURES / "tests"
REF_FIXTURES = HERE / "analysis_fixtures"
REPO = HERE.parent
SRC_PORT = REPO / "src" / "repro_torch"

PORT_RULES = ("DET001", "DET002", "DET003", "DET004", "TORCH001",
              "TORCH003", "TORCH004", "GATE002", "CON002", "CON003")
SHARED_RULES = ("DET001", "DET002", "DET003", "DET004", "CON002")

# ground truth for the corpus: every (rule, relpath, line) it must emit
EXPECTED = {
    ("DET001", "core/bad_random.py", 10),
    ("DET001", "core/bad_random.py", 11),
    ("DET001", "core/bad_random.py", 12),
    ("DET001", "core/bad_random.py", 13),
    ("DET001", "core/bad_random.py", 14),
    ("DET001", "core/bad_random.py", 15),
    ("DET001", "core/bad_random.py", 16),
    ("DET002", "faas/bad_wallclock.py", 9),
    ("DET002", "faas/bad_wallclock.py", 10),
    ("DET002", "faas/bad_wallclock.py", 11),
    ("DET003", "core/bad_hash.py", 6),
    ("DET004", "core/bad_set_iter.py", 7),
    ("DET004", "core/bad_set_iter.py", 9),
    ("DET004", "core/bad_set_iter.py", 10),
    ("TORCH001", "fl/bad_host_sync.py", 9),
    ("TORCH001", "fl/bad_host_sync.py", 15),
    ("TORCH001", "fl/bad_host_sync.py", 25),
    ("TORCH001", "fl/bad_host_sync.py", 26),
    ("TORCH001", "fl/bad_host_sync.py", 27),
    ("TORCH001", "fl/bad_host_sync.py", 39),
    ("TORCH003", "fl/bad_kernel_build.py", 19),
    ("TORCH003", "fl/bad_kernel_build.py", 20),
    ("TORCH003", "fl/bad_kernel_build.py", 25),
    ("TORCH003", "fl/bad_kernel_build.py", 26),
    ("TORCH003", "fl/bad_kernel_build.py", 27),
    ("TORCH004", "sharding/bad_axes.py", 9),
    ("TORCH004", "sharding/bad_axes.py", 16),
    ("TORCH004", "sharding/bad_axes.py", 17),
    ("TORCH004", "sharding/bad_axes.py", 18),
    ("TORCH004", "sharding/bad_axes.py", 19),
    ("TORCH004", "sharding/bad_axes.py", 20),
    ("TORCH004", "sharding/bad_axes.py", 22),
    ("TORCH004", "sharding/bad_axes.py", 27),
    ("TORCH004", "sharding/rules.py", 21),
    ("GATE002", "core/bad_env_gate.py", 5),
    ("GATE002", "core/bad_env_gate.py", 6),
    ("GATE002", "core/bad_env_gate.py", 7),
    ("GATE002", "core/bad_env_gate.py", 8),
    ("CON002", "faas/trace.py", 17),
    ("CON002", "faas/trace.py", 18),
    ("CON002", "faas/trace.py", 23),
    ("CON003", "kernels/__init__.py", 9),
    ("CON003", "kernels/__init__.py", 10),
}
# findings a line carries (the set above keeps one per line): CON003's
# orphan lacks its plain version, its csrc/ source and a test; the
# unbound kernel lacks a library and a test
EXPECTED_COUNT = len(EXPECTED) + 3


def corpus_findings(tests_dir=FIXTURE_TESTS):
    project = load_project(FIXTURES, tests_dir=tests_dir)
    return project, run_rules(project, ALL_RULES)


def _as_tuples(findings):
    return [(f.rule, f.name, f.path, f.line, f.message, f.severity)
            for f in findings]


# ------------------------------------------------------------ the corpus
def test_corpus_matches_ground_truth_exactly():
    """No missing findings, no extras — the corpus is the rule spec."""
    _, findings = corpus_findings()
    assert {(f.rule, f.path, f.line) for f in findings} == EXPECTED
    assert len(findings) == EXPECTED_COUNT


@pytest.mark.parametrize("rule_id", PORT_RULES)
def test_each_rule_fires_at_expected_lines(rule_id):
    project = load_project(FIXTURES, tests_dir=FIXTURE_TESTS)
    findings = run_rules(project, select_rules([rule_id]))
    got = {(f.rule, f.path, f.line) for f in findings}
    want = {t for t in EXPECTED if t[0] == rule_id}
    assert want and got == want


def test_every_registered_rule_has_corpus_coverage():
    """Adding a rule without a fixture proving it fires is a test gap."""
    assert {r.id for r in ALL_RULES} == {r for r, _, _ in EXPECTED}


def test_registered_rules_are_the_ported_set():
    """The JAX package's JAX001-4, GATE001 and CON001 have no rule of
    that id here: their meaning changed (new ids) or has no port."""
    assert tuple(r.id for r in ALL_RULES) == PORT_RULES
    assert len({r.name for r in ALL_RULES}) == len(ALL_RULES)


def test_findings_carry_messages_and_locations():
    _, findings = corpus_findings()
    for f in findings:
        assert f.message and f.location().endswith(f":{f.line}")
        assert f.severity == "error"


def test_con003_names_each_missing_part():
    _, findings = corpus_findings()
    by_line = {}
    for f in findings:
        if f.rule == "CON003":
            by_line.setdefault(f.line, []).append(f.message)
    assert sorted(by_line) == [9, 10]
    orphan, unbound = by_line[9], by_line[10]
    assert len(orphan) == 3 and len(unbound) == 2
    assert any("orphan_kernel_plain" in m and "no plain version" in m
               for m in orphan)
    assert any("csrc/missing.cu does not exist" in m for m in orphan)
    assert any("binds no library" in m for m in unbound)
    assert all(any("no test_torch_*.py" in m for m in ms)
               for ms in (orphan, unbound))
    assert plain_name("fed_agg_apply_sharded") == "fed_agg_apply_plain"
    assert plain_name("topk_mask") == "topk_mask_plain"


def test_con003_skips_its_test_leg_without_a_test_suite():
    _, findings = corpus_findings(tests_dir=None)
    con003 = [f for f in findings if f.rule == "CON003"]
    assert [f.line for f in con003] == [9, 9, 10]
    assert not [f for f in con003 if "test_torch" in f.message]


def test_torch001_follows_the_executors_method(tmp_path):
    """fl/executor.py hands ``self._masked_loss`` to
    ``vmap(grad_and_value(...))``: a host sync added to that method (a
    copy of the real module) is found at its line."""
    src = (SRC_PORT / "fl" / "executor.py").read_text()
    anchor = "        return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)\n"
    assert anchor in src
    mutated = src.replace(anchor, "        n = torch.sum(m).item()\n" + anchor)
    (tmp_path / "fl").mkdir()
    (tmp_path / "fl" / "executor.py").write_text(mutated)
    findings = run_rules(load_project(tmp_path), select_rules(["TORCH001"]))
    line = mutated.splitlines().index("        n = torch.sum(m).item()") + 1
    assert [(f.path, f.line) for f in findings] == [("fl/executor.py", line)]
    assert "self._masked_loss" in findings[0].message
    assert "torch.func.vmap" in findings[0].message


def test_torch004_reads_the_ports_vocabulary():
    from repro_torch.sharding.rules import MESH_AXES

    project = load_project(SRC_PORT)
    assert UndeclaredMeshAxisRule()._declared_axes(project) == set(MESH_AXES)


def test_gate002_has_no_exempt_module(tmp_path):
    """The JAX package exempts its gates registry; the port has none, so
    the same read in analysis/gates.py is a finding."""
    (tmp_path / "analysis").mkdir()
    (tmp_path / "analysis" / "gates.py").write_text(
        'import os\nX = os.environ.get("REPRO_COMPRESS", "1")\n')
    findings = run_rules(load_project(tmp_path), select_rules(["GATE002"]))
    assert [(f.path, f.line) for f in findings] == [("analysis/gates.py", 2)]


# ------------------------------------------------------------- pragmas
def test_pragma_suppresses_by_id_and_slug():
    """core/pragma_ok.py violates DET003 and DET001 twice, each pragma'd
    (by rule id or by slug) with its reason beside it."""
    _, findings = corpus_findings()
    assert not [f for f in findings if f.path == "core/pragma_ok.py"]
    project = load_project(FIXTURES / "core" / "pragma_ok.py")
    ctx = project.files[0]
    assert ctx.tree is not None
    unfiltered = [f for rule in ALL_RULES if rule.applies(ctx.relpath)
                  for f in rule.check_file(ctx, project)]
    assert sorted((f.rule, f.line) for f in unfiltered) == [
        ("DET001", 14), ("DET001", 18), ("DET003", 10)]


def test_pragma_only_covers_its_own_line(tmp_path):
    src = ('import torch\n'
           'def f(a):\n'
           '    x = torch.randn(3)  # repro-lint: disable=DET001 — reason\n'
           '    return torch.randn(3) + x\n')
    p = tmp_path / "mod.py"
    p.write_text(src)
    findings = run_rules(load_project(p), select_rules(["DET001"]))
    assert [f.line for f in findings] == [4]


# ------------------------------------------------------------- baseline
def test_baseline_round_trip(tmp_path):
    """write -> load -> partition grandfathers the whole corpus."""
    project, findings = corpus_findings()
    path = tmp_path / "baseline.json"
    baseline_mod.write(path, project, findings)
    base = baseline_mod.load(path)
    assert len(base) == len(findings)
    new, old = baseline_mod.partition(project, findings, base)
    assert new == [] and len(old) == len(findings)


def test_baseline_fingerprint_survives_renumbering(tmp_path):
    """Inserting lines above a finding must not invalidate the baseline
    (it keys on line content, not line number) — but editing the flagged
    line itself must."""
    corpus = tmp_path / "corpus"
    shutil.copytree(FIXTURES, corpus)
    project = load_project(corpus, tests_dir=corpus / "tests")
    findings = run_rules(project, ALL_RULES)
    path = tmp_path / "baseline.json"
    baseline_mod.write(path, project, findings)
    base = baseline_mod.load(path)

    target = corpus / "core" / "bad_random.py"
    target.write_text("# pushed down\n# two lines\n" + target.read_text())
    project2 = load_project(corpus, tests_dir=corpus / "tests")
    new, _ = baseline_mod.partition(project2,
                                    run_rules(project2, ALL_RULES), base)
    assert new == []                       # renumbering: still baselined

    target.write_text(target.read_text().replace(
        "a = torch.randn(3) ", "a = torch.randn(4) "))
    project3 = load_project(corpus, tests_dir=corpus / "tests")
    new, _ = baseline_mod.partition(project3,
                                    run_rules(project3, ALL_RULES), base)
    assert [(f.rule, f.path) for f in new] == [
        ("DET001", "core/bad_random.py")]  # edited line: resurfaces


def test_line_fingerprint_strips_indentation(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("x = torch.randn(3)\n")
    a = line_fingerprint(FileContext(p, "m.py"), 1)
    p.write_text("    x = torch.randn(3)\n")
    b = line_fingerprint(FileContext(p, "m.py"), 1)
    assert a == b


def test_duplicate_line_occurrence_index():
    """Every finding of the corpus gets its own fingerprint, the CON003
    lines with several findings too (:0, :1, :2)."""
    project, findings = corpus_findings()
    fps = baseline_mod.fingerprints(project, findings)
    assert len(fps) == len(set(fps))
    assert sum(fp.endswith(":2") for fp in fps) == 1


# ----------------------------------------------------- the real package
def test_src_repro_torch_clean_with_empty_baseline():
    """The port carries no finding, and the committed baseline
    grandfathers none."""
    assert baseline_mod.load() == {}
    assert json.loads(baseline_mod.DEFAULT_BASELINE.read_text())[
        "findings"] == {}
    project = load_project(SRC_PORT, tests_dir=HERE)
    findings = run_rules(project, ALL_RULES)
    assert findings == [], [f"{f.location()}: {f.rule} {f.message}"
                            for f in findings]


def test_syntax_error_becomes_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    findings = run_rules(load_project(p), ALL_RULES)
    assert [f.rule for f in findings] == ["E000"]


def test_select_rules_rejects_unknown():
    with pytest.raises(KeyError):
        select_rules(["NOPE999"])
    with pytest.raises(KeyError):
        select_rules(["JAX001"])           # the port's id is TORCH001


def test_select_rules_by_id_and_slug():
    picked = select_rules(["host-sync-in-transform", "con003", "TORCH001"])
    assert [r.id for r in picked] == ["TORCH001", "CON003"]


# --------------------------------------------- parity with repro.analysis
@pytest.mark.parametrize("rule_id", SHARED_RULES)
def test_shared_rule_matches_reference_on_its_corpus(rule_id):
    """The port's engine and rule over tests/analysis_fixtures/ give
    exactly repro.analysis's findings: rule, slug, path, line, message."""
    port = run_rules(load_project(REF_FIXTURES), select_rules([rule_id]))
    ref = ref_core.run_rules(ref_core.load_project(REF_FIXTURES),
                             ref_select_rules([rule_id]))
    assert ref and _as_tuples(port) == _as_tuples(ref)


def test_shared_rules_together_match_reference():
    port = run_rules(load_project(REF_FIXTURES), select_rules(SHARED_RULES))
    ref = ref_core.run_rules(ref_core.load_project(REF_FIXTURES),
                             ref_select_rules(SHARED_RULES))
    assert _as_tuples(port) == _as_tuples(ref)


def test_line_fingerprint_agrees_with_reference():
    port = load_project(REF_FIXTURES)
    ref = ref_core.load_project(REF_FIXTURES)
    assert [c.relpath for c in port.files] == [c.relpath for c in ref.files]
    n = 0
    for pc, rc in zip(port.files, ref.files):
        for line in range(0, len(pc.lines) + 2):
            assert line_fingerprint(pc, line) == ref_core.line_fingerprint(
                rc, line), (pc.relpath, line)
            n += 1
    assert n > 100


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_baseline_loads_across_packages(writer, tmp_path):
    """A baseline written by either package grandfathers the shared
    rules' findings in the other."""
    path = tmp_path / "baseline.json"
    port_project = load_project(REF_FIXTURES)
    port_findings = run_rules(port_project, select_rules(SHARED_RULES))
    ref_project = ref_core.load_project(REF_FIXTURES)
    ref_findings = ref_core.run_rules(ref_project,
                                      ref_select_rules(SHARED_RULES))
    if writer == "reference":
        ref_baseline.write(path, ref_project, ref_findings)
        base = baseline_mod.load(path)
        new, old = baseline_mod.partition(port_project, port_findings, base)
        assert new == [] and len(old) == len(port_findings)
    else:
        baseline_mod.write(path, port_project, port_findings)
        base = ref_baseline.load(path)
        new, old = ref_baseline.partition(ref_project, ref_findings, base)
        assert new == [] and len(old) == len(ref_findings)
    assert base == json.loads(path.read_text())["findings"]
    assert (baseline_mod.fingerprints(port_project, port_findings)
            == ref_baseline.fingerprints(ref_project, ref_findings))


# ------------------------------------------------------------ CLI
def _run_cli(*argv):
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=REPO)


def test_cli_json_on_corpus(tmp_path):
    out = tmp_path / "report.json"
    proc = _run_cli(str(FIXTURES), "--format", "json", "--no-baseline",
                    "--tests-dir", str(FIXTURE_TESTS), "--output", str(out))
    assert proc.returncode == 1            # corpus is all violations
    report = json.loads(out.read_text())
    assert report["summary"]["new"] == EXPECTED_COUNT
    assert report["summary"]["rules"] == sorted(PORT_RULES)
    got = {(f["rule"], f["path"], f["line"]) for f in report["findings"]}
    assert got == EXPECTED
    assert all(f["fingerprint"] for f in report["findings"])


def test_cli_text_on_corpus():
    proc = _run_cli(str(FIXTURES), "--no-baseline", "--rules",
                    "GATE002,unseeded-random", "--tests-dir",
                    str(FIXTURE_TESTS))
    assert proc.returncode == 1
    lines = proc.stdout.splitlines()
    assert lines[-1] == "repro-lint: 11 finding(s) across 2 rule(s)"
    assert lines[0].startswith("core/bad_env_gate.py:5: GATE002 "
                               "(no-env-gate) ")


def test_cli_clean_tree_exits_zero():
    proc = _run_cli(str(SRC_PORT), "--tests-dir", str(HERE))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == ("repro-lint: 0 finding(s) across 10 "
                                   "rule(s)")


def test_cli_default_root_is_the_port():
    """No arguments: src/repro_torch with tests/ beside it."""
    proc = _run_cli("--format", "json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = json.loads(proc.stdout)["summary"]
    assert summary["new"] == 0 and summary["files"] > 80


def test_cli_rejects_unknown_rule():
    proc = _run_cli("--rules", "JAX002")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_cli_list_rules():
    proc = _run_cli("--list-rules")
    assert proc.returncode == 0
    for rule in ALL_RULES:
        assert rule.id in proc.stdout and rule.name in proc.stdout


def test_cli_imports_no_torch_jax_or_repro():
    """The linter is stdlib only: linting the port loads neither torch nor
    JAX nor the JAX package."""
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--format', 'json', '--output', sys.argv[1]])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'repro', 'numpy'))\n"
            "print(rc, bad, file=sys.stderr)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "/dev/null"], capture_output=True,
        text=True, env={"PYTHONPATH": str(REPO / "src"),
                        "PATH": "/usr/bin:/bin"}, cwd=REPO)
    assert proc.stderr.strip().splitlines()[-1] == "0 []"
