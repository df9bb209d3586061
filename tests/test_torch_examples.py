"""The port's example CLIs against the JAX package's (repro_torch.examples
and examples/*.py): quickstart, straggler_study, scheduler_study and
serve_decode.  tests/test_torch_examples_runs.py holds the other three.

Each pair runs in this process at a small setting through its own flags
(quickstart, which has none, at its own), the port's with ``--device
cpu`` and its model's init params drawn by the JAX package
(``torch_parity_common.with_jax_init``).  The printed tables agree line
by line: the virtual columns as text, accuracies within 0.01 (largest
gaps measured: quickstart 0, straggler_study 0, scheduler_study 0).  The
trace files the studies write are equal byte for byte.  serve_decode's
greedy tokens equal the JAX example's; a sampled run is held by what it
draws from (torch's generator cannot be ``jax.random``'s): the first
step's probabilities against the JAX model's softmax(logits / T).
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import small as jax_small
from repro_torch.convert import params_from_numpy
from repro_torch.examples import (quickstart, scheduler_study,
                                  serve_decode, straggler_study)
from repro_torch.models import small
from torch_parity_common import (assert_outputs_agree, jax_example,
                                 np_tree, run_main, with_jax_init)

VERBOSE_ACC = r"acc=([\d.]+)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart(monkeypatch, capsys):
    ref = jax_example("quickstart")
    want_rc, want = run_main(monkeypatch, capsys, ref, [])
    monkeypatch.setattr(quickstart, "make_cnn",
                        with_jax_init(jax_small.make_cnn, small.make_cnn))
    rc, got = run_main(monkeypatch, capsys, quickstart, ["--device", "cpu"])
    assert rc == want_rc == 0
    assert "=== fedlesscan ===" in got
    assert_outputs_agree(want, got, [VERBOSE_ACC,
                                     r"final accuracy : ([\d.]+)"])


def test_straggler_study(monkeypatch, capsys):
    """chip_smoke.py's setting on 12 clients, where the accuracies agree
    exactly.  Local Adam at ReLU margins (ROADMAP Queue 3) moves the
    speech CNN's accuracies by about 0.01 elsewhere: at ``--ratios 0,0.3
    --rounds 2`` fedavg at 0 % ended 0.012 apart (0.169 against 0.157),
    and at 24 clients (chip_smoke.py's own) one row ended 0.012 apart."""
    flags = ["--ratios", "0.3", "--rounds", "4", "--clients", "12"]
    ref = jax_example("straggler_study")
    want_rc, want = run_main(monkeypatch, capsys, ref, flags)
    monkeypatch.setattr(straggler_study, "make_speech_cnn",
                        with_jax_init(jax_small.make_speech_cnn,
                                      small.make_speech_cnn))
    rc, got = run_main(monkeypatch, capsys, straggler_study,
                       flags + ["--device", "cpu"])
    assert rc == want_rc == 0
    assert len(got.splitlines()) == 1 + 3              # header, 3 runs
    assert_outputs_agree(want, got, [r"^\w+ +\d+% +([\d.]+) "])


def test_scheduler_study(monkeypatch, capsys, tmp_path):
    """Its exit code is its acceptance (1 when apodotiko's EUR falls below
    the fedlesscan scheduler's, as at this setting in both packages)."""
    flags = ["--rounds", "3", "--clients", "8", "--cohort", "4",
             "--eval-every", "1"]
    ref = jax_example("scheduler_study")
    monkeypatch.setattr(ref, "OUT", tmp_path / "jax")
    want_rc, want = run_main(monkeypatch, capsys, ref, flags)
    monkeypatch.setattr(scheduler_study, "OUT", tmp_path / "port")
    monkeypatch.setattr(scheduler_study, "make_cnn",
                        with_jax_init(jax_small.make_cnn, small.make_cnn))
    rc, got = run_main(monkeypatch, capsys, scheduler_study,
                       flags + ["--device", "cpu"])
    assert rc == want_rc
    assert ("REGRESSION" in got) == (rc == 1)
    assert_outputs_agree(want, got, [r"^\w+ +([\d.]+) +[\d.]+ +(?:inf|\d)"])
    for name in scheduler_study.SCHEDULERS:
        trace = (tmp_path / "port" / f"{name}.jsonl").read_bytes()
        assert trace and trace == (tmp_path / "jax" / f"{name}.jsonl"
                                   ).read_bytes()


SERVE = ["--arch", "mamba2-130m", "--batch", "2", "--prompt-len", "8",
         "--new", "4"]


def _jax_inputs(ref, arch, B, S):
    """The JAX example's params and prompt for (``arch``, B, S): init
    from PRNGKey(0), the prompt from PRNGKey(1)."""
    cfg = ref.get_config(arch).reduced()
    params = ref.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab)
    return cfg, params, prompt


def _port_inputs(ref, monkeypatch):
    """Point serve_decode.make_inputs at the JAX example's draws."""
    def make_inputs(cfg, batch, prompt_len, device):
        _, params, prompt = _jax_inputs(ref, cfg.name, batch, prompt_len)
        return (params_from_numpy(np_tree(params), device),
                torch.from_numpy(np.asarray(prompt)).to(device), None,
                torch.Generator(device=device).manual_seed(1))
    monkeypatch.setattr(serve_decode, "make_inputs", make_inputs)


def test_serve_decode_greedy_matches_the_jax_example(monkeypatch, capsys):
    ref = jax_example("serve_decode")
    want_rc, want = run_main(monkeypatch, capsys, ref, SERVE)
    _port_inputs(ref, monkeypatch)
    rc, got = run_main(monkeypatch, capsys, serve_decode,
                       SERVE + ["--device", "cpu"])
    assert rc == want_rc == 0
    times = r"in ([\d.]+)s|\(([\d.]+) tok/s"
    strip = [re.sub(times, "<t>", line) for line in got.splitlines()]
    assert strip == [re.sub(times, "<t>", line)
                     for line in want.splitlines()]
    assert got.splitlines()[-1].startswith("generated ids: [[")


def test_serve_decode_samples_from_the_jax_models_distribution(
        monkeypatch, capsys):
    T = 0.8
    ref = jax_example("serve_decode")
    rc, out = run_main(monkeypatch, capsys, ref, SERVE + ["--temperature",
                                                          str(T)])
    assert rc == 0
    _port_inputs(ref, monkeypatch)
    drawn = []
    multinomial = torch.multinomial

    def spy(probs, *args, **kwargs):
        drawn.append(probs.clone())
        return multinomial(probs, *args, **kwargs)
    monkeypatch.setattr(torch, "multinomial", spy)
    rc, got = run_main(monkeypatch, capsys, serve_decode,
                       SERVE + ["--temperature", str(T), "--device", "cpu"])
    assert rc == 0 and len(drawn) == 4
    ids = np.array(json.loads(got.splitlines()[-1].split(":", 1)[1]))
    cfg, params, prompt = _jax_inputs(ref, "mamba2-130m", 2, 8)
    assert ids.shape == (2, 4) and (ids >= 0).all() and (ids < cfg.vocab).all()
    # the first step feeds the prompt's last token: both packages draw
    # from the same distribution there
    _, cache = ref.prefill(cfg, params, {"tokens": prompt}, cache_len=12,
                           cache_dtype=jnp.float32)
    logits, _ = ref.decode_step(cfg, params, cache, prompt[:, -1:],
                                jnp.full((2,), 8, jnp.int32))
    want = jax.nn.softmax(logits[:, -1, :cfg.vocab] / T, axis=-1)
    np.testing.assert_allclose(drawn[0].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6)
    for probs, nxt in zip(drawn, ids.T):
        assert (probs[np.arange(2), nxt] > 0).all()
