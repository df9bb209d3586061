"""The plain reference against the program at a tiny size on the CPU:
the same weights give the same CNN logits, LM logits, SSD scan, Adam
step and flatten order.  (This test imports both; the reference itself
imports nothing of the program.)"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import tiny  # noqa: E402
from bench_port.drivers import program  # noqa: E402
from bench_port.reference import models, weights  # noqa: E402
from bench_port.reference import train as ref_train  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5      # float32, two orders of summation


@pytest.fixture(scope="module")
def cnn():
    return tiny.tiny_cell("femnist_cnn.fedlesscan.k64").config


@pytest.fixture(scope="module")
def lm():
    return tiny.tiny_cell("mamba2_130m.train.b8s4096").config


def test_cnn_logits(cnn):
    params = program.make_weights(cnn, 3, "cpu")
    m = cnn["model"]
    x = torch.randn(5, m["image_size"], m["image_size"], m["channels"],
                    generator=torch.Generator().manual_seed(1))
    got = program.model_def(cnn).apply(params, x)
    torch.testing.assert_close(models.cnn_forward(params, x), got,
                               rtol=RTOL, atol=ATOL)


def test_lm_logits(lm):
    from repro_torch.models import forward
    params = program.make_weights(lm, 4, "cpu")
    cfg = program.arch_config(lm["model"], lm["precision"])
    tokens = torch.randint(0, lm["model"]["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(2))
    got = forward(cfg, params, {"tokens": tokens})
    want = models.lm_logits(params, models.lm_hidden(params, tokens,
                                                      lm["model"]))
    torch.testing.assert_close(want, got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("l", [16, 64])
def test_ssd_against_the_programs_plain_scan(l):
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    gen = torch.Generator().manual_seed(l)
    b, h, p, n = 2, 3, 4, 8
    X = torch.randn(b, l, h, p, generator=gen)
    A = -torch.rand(b, l, h, generator=gen)
    B = torch.randn(b, l, n, generator=gen)
    C = torch.randn(b, l, n, generator=gen)
    want = models.ssd(X, A, B, C, chunk=16)
    got = ssd_scan_plain(X, A, B[:, :, None].expand(b, l, h, n),
                         C[:, :, None].expand(b, l, h, n), chunk=16)
    torch.testing.assert_close(want, got, rtol=1e-4, atol=1e-4)


def test_flatten_order_is_the_programs(lm):
    from repro_torch.core.flatten import flatten_params
    params = program.make_weights(lm, 5, "cpu")
    got, _ = flatten_params(params)
    assert torch.equal(weights.flat(params), got)


def test_adam_is_the_programs():
    from repro_torch.optim import make_optimizer
    gen = torch.Generator().manual_seed(6)
    p = {"w": torch.randn(7, generator=gen)}
    opt = make_optimizer("adam", 1e-3)
    ref = ref_train.Adam(1e-3)
    state, rstate, rp = opt.init(p), ref.init(p), dict(p)
    from repro_torch.optim import apply_updates
    for _ in range(3):
        g = {"w": torch.randn(7, generator=gen)}
        upd, state = opt.update(g, state, p)
        p = apply_updates(p, upd)
        rp = ref.step(rp, g, rstate)
    torch.testing.assert_close(rp["w"], p["w"], rtol=1e-6, atol=1e-7)


def test_batch_schedule_is_the_executors():
    from repro_torch.fl.executor import _batch_indices
    idx, mask = _batch_indices(23, 5, 3, np.random.default_rng(9))
    mine = ref_train.batch_schedule(23, 5, 3, 9)
    assert len(mine) == idx.shape[0]
    for got, m, want in zip(idx, mask, mine):
        assert list(got[m > 0]) == list(want)


def test_client_seed_is_the_pools():
    from repro_torch.fl.client import ClientPool
    pool = ClientPool.__new__(ClientPool)
    pool.seed = 2 ** 31 + 77
    assert pool.client_seed("client_3", 4) == \
        ref_train.client_seed("client_3", 4, 2 ** 31 + 77)
