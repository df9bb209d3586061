"""Nemotron-H (nemotron-3-nano-30b-a3b) in the port against the plain
reference ``torch_nemotron_h_reference`` on seeded random weights, at a
small size on the CPU: d 64, 4 Mamba heads of 16 in 2 groups, 8 relu²
experts of 32 with top 2 and a shared expert of 48, 4 query and 2 KV heads
of 16, the pattern ``MEM*E``, all in float32.

Tolerances, float32 on both sides: the port scans chunk by chunk and the
reference position by position, the port's attention is SDPA and its CE
runs in chunks, so sums are taken in other orders.  Logits within 1e-5 of
their largest magnitude, the loss within 1e-6 relative, each gradient
leaf within 1e-4 of its norm (relative L2), and one Adam step's change of
each leaf within 1e-3 relative L2: the change is read as p1 − p0 in
float32 at |p| up to about 1, where an ulp of p is 4e-4 of the learning
rate; and Adam divides by |g|, so an element whose gradient is a rounding
error moves by up to the learning rate: such elements are left out, below
1e-4 of the leaf's largest gradient.
"""
import numpy as np
import pytest
import torch

import torch_nemotron_h_reference as ref
from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.launch import pretrain
from repro_torch.models import make_train_step
from repro_torch.models.moe import moe_layer
from repro_torch.models.transformer import (forward, grads_of, init_params,
                                            loss_fn)
from repro_torch.optim import make_optimizer

PATTERN = ("mamba", "moe", "mamba", "attn_only", "moe")
LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(**kw):
    return get_config("nemotron-3-nano-30b-a3b").replace(**{
        "n_layers": len(PATTERN), "pattern": PATTERN, "d_model": 64,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "d_ff": 32,
        "vocab": 97, "n_experts": 8, "top_k": 2, "shared_expert_ff": 48,
        "ssm_state": 8, "ssm_head_dim": 16, "ssm_n_heads": 4,
        "ssm_groups": 2, "ce_chunk": 24, "dtype": "float32",
        "remat": False, "learning_rate": LR, **kw})


def batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1)))
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _params(cfg, seed=0):
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    # the correction bias away from zero, so the choice it steers is held
    # to the reference's
    for i, kind in enumerate(cfg.pattern):
        if kind == "moe":
            bias = params["blocks"][f"pos{i}"]["moe"]["router_bias"]
            bias.copy_(torch.linspace(-0.3, 0.3, bias.shape[-1]))
    return params


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_forward_and_loss_match_the_reference():
    cfg = small()
    params, b = _params(cfg), batch(cfg)
    with torch.no_grad():
        got = forward(cfg, params, b)
        want = ref.logits(params, b["tokens"], cfg)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert abs(float(loss_fn(cfg, params, b))
                   / float(ref.loss(params, b["tokens"], b["labels"], cfg))
                   - 1) < 1e-6


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_and_an_adam_step_match_the_reference(remat):
    """Per-leaf gradients (the zero-gradient correction bias included)
    and one step of ``make_train_step``, with and without remat block by
    block and the chunked CE recomputed."""
    cfg = small(remat=remat)
    b = batch(cfg, seed=1)
    params = _params(cfg, seed=1)
    _, grads = grads_of(cfg, params, b)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                    params)
    leaves = tree_leaves(live)
    want = torch.autograd.grad(
        ref.loss(live, b["tokens"], b["labels"], cfg), leaves,
        materialize_grads=True)
    for g, w in zip(tree_leaves(grads), want):
        if w.norm() == 0:
            assert g.norm() == 0
        else:
            assert _rel(g, w) < 1e-4
    step, _ = make_train_step(cfg)
    new, _ = step({"params": params,
                   "opt": make_optimizer("adam", LR).init(params)}, b)
    for p0, p1, w in zip(tree_leaves(params), tree_leaves(new["params"]),
                         want):
        # the reference Adam step from zero moments: lr · g / (|g| + eps)
        update = -LR * w / (w.abs() + 1e-8)
        moved = w.abs() > 1e-4 * w.abs().max()
        if moved.any():
            assert _rel((p1 - p0)[moved], update[moved]) < 1e-3
        assert torch.equal(p1[w == 0], p0[w == 0])



@pytest.mark.parametrize("arch", ["nemotron-3-nano-30b-a3b",
                                  "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-11b", "zamba2-1.2b"])
def test_remat_takes_blocks_only_in_single_mixer_stacks(monkeypatch, arch):
    """Remat checkpoints each block of a stack of the single-mixer kinds
    and a superblock at a time everywhere else, a stack of one superblock
    included, as the JAX package does."""
    from repro_torch.models import transformer
    if arch == "nemotron-3-nano-30b-a3b":
        cfg = small(remat=True)
    else:
        base = get_config(arch).reduced()
        cfg = base.replace(n_layers=base.period, remat=True,
                           dtype="float32")
    seen = []
    real = transformer.checkpoint

    def spy(fn, *args, **kw):
        seen.append(fn.__name__)
        return real(fn, *args, **kw)
    monkeypatch.setattr(transformer, "checkpoint", spy)
    grads_of(cfg, init_params(cfg, torch.Generator().manual_seed(0)),
             batch(cfg, S=16))
    if cfg.single_mixer:
        assert seen == ["_apply_block"] * cfg.n_layers
    else:
        assert cfg.n_super == 1 and seen == ["_superblock"]

def test_held_halves_add_up_to_the_whole_layer():
    """Eight experts split into two held halves of four (experts 0–3 and
    4–7): the halves' outputs summed, the shared expert counted once,
    equal the reference layer with all eight."""
    cfg = small()
    p = _params(cfg)["blocks"]["pos1"]["moe"]
    p = {k: (v[0] if not isinstance(v, dict)
             else {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        whole = ref.moe(p, x, cfg)
        halves = [moe_layer(dict(p, up=p["up"][s], down=p["down"][s]), x,
                            cfg.replace(held_experts=4), first=f)
                  for s, f in ((slice(0, 4), 0), (slice(4, 8), 4))]
        shared = ref.relu2_mlp(x, p["shared"]["up"], p["shared"]["down"])
        torch.testing.assert_close(halves[0] + halves[1] - shared, whole,
                                   rtol=1e-5, atol=1e-5)


def test_dropless_at_a_skewed_router():
    """Every token routed to experts 0 and 1 (their correction bias far
    above the rest): each of the two takes all T rows, none is dropped,
    and the layer equals the reference's; the counters count T·k pairs
    and the larger expert's T rows."""
    cfg = small()
    p = _params(cfg)["blocks"]["pos1"]["moe"]
    p = {k: (v[0] if not isinstance(v, dict)
             else {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    p["router_bias"] = torch.tensor([50.0, 40.0] + [0.0] * 6)
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    tracing.drain()
    tracing.enable()
    try:
        with torch.no_grad():
            got = moe_layer(p, x, cfg)
    finally:
        tracing.enable(False)
    _, counts = tracing.drain()
    T = x.shape[0] * x.shape[1]
    assert counts == {"moe.routed_pairs": 2 * T, "moe.max_expert_rows": T}
    with torch.no_grad():
        torch.testing.assert_close(got, ref.moe(p, x, cfg), rtol=1e-5,
                                   atol=1e-5)


def test_pretrain_runs_the_reduced_config(capsys):
    """``launch/pretrain.py --arch nemotron-3-nano-30b-a3b`` on the CPU at
    the reduced size: two steps, finite losses."""
    pretrain.main(["--arch", "nemotron-3-nano-30b-a3b", "--device", "cpu",
                   "--steps", "2", "--batch", "2", "--seq", "16",
                   "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step" in out and "nan" not in out.lower()


def test_serving_and_the_sharded_step_refuse_it():
    from repro_torch.launch.serve import generate
    from repro_torch.launch.sharded import make_sharded_train_step
    cfg = small()
    with pytest.raises(ValueError, match="nemotron-3-nano-30b-a3b"):
        generate(cfg, _params(cfg), torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(ValueError, match="nemotron-3-nano-30b-a3b"):
        make_sharded_train_step(cfg, None)
