"""SSM and hybrid decoders through the port's vectorized executor.

The executor trains a cohort as one ``torch.func.vmap(grad_and_value(...))``
step, so every Mamba block's ``ssd_scan`` runs under ``vmap`` and
``grad``.  ``_SSDScan``'s vmap rule folds the vmapped dim into the scan's
batch dim (one launch a call on the card); its backward is
``torch.func.vjp`` of the plain version.  Remat runs no checkpoint under a
``torch.func`` transform (``torch.func.grad`` cannot run checkpoint's
saved-tensor hooks).

On the CPU the scan's wrapper runs its plain version, so the Function
under vmap is held bit for bit against ``ssd_scan_plain`` under vmap.
The experiments are ``federated_pretrain``'s setting (the example's
``ModelDef`` over a reduced config with vocab 256, its token stream and
its 12 shards), cut to the first 4 clients and no evaluation: the JAX
package's executor, the port's executor and the port's eager loop from
the same injected params.  Local SGD at the example's lr (1e-3) keeps the
comparison off Queue 3's Adam amplification; the traces agree byte for
byte, the params within 1e-4 (the bound of tests/test_torch_executor.py's
experiments) and each run's update, final − init over the whole tree,
within 1e-3 relative L2 of the JAX executor's (2.0e-4 measured on
zamba2, 9.2e-5 on mamba2), so a dropped gradient term shows though the
update is small.  At lr 0.01 zamba2 is too sensitive for a 1e-4 bound:
from params 9e-6 apart after five steps, the sixth step's grads differ
by 3 % (conv_b), in the port's two paths as against JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro.fl import controller as jax_controller
from repro.fl import experiment as jax_experiment
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.flatten import tree_leaves
from repro_torch.examples import federated_pretrain
from repro_torch.fl import experiment
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.kernels.ssd_scan import _fold, ssd_scan, ssd_scan_plain
from repro_torch.models import transformer
from torch_parity_common import jax_example

N_CLIENTS = 4
# the example's task with local SGD in place of Adam, at its lr
SGD = dict(epochs=1, batch_size=16, learning_rate=1e-3, optimizer="sgd",
           per_sample_time_s=0.02)
UPDATE_REL_L2 = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the Function
V, b, l, h, p, n = 3, 2, 20, 4, 8, 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(V, b, l, h, p)), -rng.uniform(size=(V, b, l, h)),
        rng.normal(size=(V, b, l, n)), rng.normal(size=(V, b, l, n)))]


def _loss(scan):
    """A loss of y and the final state, with B and C head-broadcast
    views (head stride 0), as models/ssm.py passes them."""
    def f(x, a, Bm, Cm):
        B = Bm[:, :, None, :].expand(b, l, h, n)
        C = Cm[:, :, None, :].expand(b, l, h, n)
        y, state = scan(x, a, B, C, chunk=8, return_state=True)
        return (y ** 2).sum() + (state * 1.5).sum()
    return f


def _assert_bit_equal(got, want):
    for u, v in zip(got, want):
        assert torch.equal(u, v)


def test_vmap_grad_of_ssd_scan_equals_plain_bit_for_bit():
    args = _inputs()
    got = vmap(grad_and_value(_loss(ssd_scan),
                              argnums=(0, 1, 2, 3)))(*args)
    want = vmap(grad_and_value(_loss(ssd_scan_plain),
                               argnums=(0, 1, 2, 3)))(*args)
    _assert_bit_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_vmap_grad_with_an_unbatched_input():
    """C's (b, l, n) comes in at in_dims None: the rule expands it over
    the vmapped dim before it folds."""
    x, a, Bm, Cm = _inputs(1)
    fns = [vmap(grad(_loss(scan), argnums=(0, 1, 2)),
                in_dims=(0, 0, 0, None))
           for scan in (ssd_scan, ssd_scan_plain)]
    _assert_bit_equal(fns[0](x, a, Bm, Cm[0]), fns[1](x, a, Bm, Cm[0]))


def test_vmap_forward_without_state():
    x, a, Bm, Cm = _inputs(2)

    def y_of(scan):
        def f(x, a, Bm, Cm):
            return scan(x, a, Bm[:, :, None, :].expand(b, l, h, n),
                        Cm[:, :, None, :].expand(b, l, h, n), chunk=16)
        return f
    assert torch.equal(vmap(y_of(ssd_scan))(x, a, Bm, Cm),
                       vmap(y_of(ssd_scan_plain))(x, a, Bm, Cm))


@pytest.mark.parametrize("bdim", [0, 1, None])
def test_fold_keeps_the_head_broadcast_a_view(bdim):
    """The fold of a head-broadcast (…, l, h, n) view: (V·b, l, h, n)
    with head stride 0, equal to the materialised fold, and a view of the
    input wherever the strides allow (bdim 0 of a contiguous base)."""
    base = torch.arange(V * b * l * n, dtype=torch.float32)
    if bdim is None:
        base = base[:b * l * n].reshape(b, l, n)
        view = base[:, :, None, :].expand(b, l, h, n)
        want = view.unsqueeze(0).expand(V, b, l, h, n)
    else:
        base = base.reshape(V, b, l, n).movedim(0, bdim)
        view = base.unsqueeze(-2).expand(*base.shape[:-1], h, n)
        want = view.movedim(bdim, 0)
    folded = _fold(view, bdim, V)
    assert folded.shape == (V * b, l, h, n)
    assert folded.stride(2) == 0 and folded.stride(-1) == 1
    assert torch.equal(folded, want.reshape(V * b, l, h, n))
    if bdim == 0:
        assert folded.data_ptr() == view.data_ptr()


# ------------------------------------------------------------ remat
def test_remat_is_off_under_func_transforms(monkeypatch):
    """forward checkpoints its superblocks under autograd, not under a
    torch.func transform (whose grad cannot run saved-tensor hooks)."""
    calls = []
    real = transformer.checkpoint

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(transformer, "checkpoint", spy)
    cfg = (federated_pretrain.get_config("mamba2-130m").reduced()
           .replace(vocab=64, remat=True))
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (3, 2, 8),
                           generator=torch.Generator().manual_seed(1))

    def loss(params, tok):
        return transformer.forward(cfg, params, {"tokens": tok}).sum()
    vmapped = vmap(grad(loss), in_dims=(None, 0))(params, tokens)
    assert calls == []
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss(params, tokens[0]).backward()
    assert len(calls) == cfg.n_super
    for got, t in zip(tree_leaves(vmapped), leaves):
        # the same function, its sums in another order: relative L2
        assert (got[0] - t.grad).norm() <= 1e-5 * t.grad.norm()


# ------------------------------------------------------------ experiments
def _run_three(tmp_path, monkeypatch, arch, remat, rounds):
    """The JAX package's executor, the port's executor and the port's
    eager loop on ``federated_pretrain``'s setting (4 clients), from the
    same init params; returns the final params of each."""
    jax_ex = jax_example("federated_pretrain")
    parts, _ = federated_pretrain.build_experiment(12)
    parts = {cid: parts[cid] for cid in list(parts)[:N_CLIENTS]}
    jax_model = jax_ex.arch_as_model(arch)
    if remat:
        jcfg = jax_ex.get_config(arch).reduced().replace(vocab=256,
                                                          remat=True)
        jax_model = jax_model._replace(
            init=lambda rng: jax_ex.init_params(jcfg, rng),
            apply=lambda params, tokens: jax_ex.forward(
                jcfg, params, {"tokens": tokens})[:, -1, :])
    jax_task = JaxTask(jax_model, JaxTaskConfig(**SGD))
    init = jax.tree_util.tree_map(np.asarray, jax_task.init_params(0))
    final = {}
    run = jax_controller.Controller.run

    def keep_params(self, *args, **kwargs):
        final["params"], result = run(self, *args, **kwargs)
        return final["params"], result
    monkeypatch.setattr(jax_controller.Controller, "run", keep_params)

    def cfg(module, name, vectorized):
        return module.ExperimentConfig(
            strategy="fedlesscan", n_rounds=rounds, clients_per_round=4,
            eval_every=0, vectorized=vectorized,
            trace_path=str(tmp_path / f"{name}.jsonl"),
            scenario=module.ScenarioConfig(straggler_fraction=0.25,
                                           round_timeout_s=60.0))
    jax_experiment.run_experiment(
        jax_task, parts, None, cfg(jax_experiment, "jax", True),
        initial_params=jax.tree_util.tree_map(jnp.asarray, init))
    out = {"init": init, "jax": final["params"]}
    pcfg = (federated_pretrain.get_config(arch).reduced()
            .replace(vocab=256, remat=remat))
    task = ClassificationTask(
        federated_pretrain.cfg_as_model(pcfg, "lm"), TaskConfig(**SGD),
        device="cpu")
    for name, vectorized in (("vec", True), ("eager", False)):
        out[name], _ = experiment.run_experiment(
            task, parts, None, cfg(experiment, name, vectorized),
            initial_params=params_from_numpy(init, "cpu"), device="cpu",
            return_params=True)
    return out


@pytest.mark.parametrize("arch,remat,rounds", [
    ("mamba2-130m", False, 2), ("zamba2-1.2b", False, 1),
    ("mamba2-130m", True, 1)])
def test_ssm_experiment_through_the_executor(tmp_path, monkeypatch, arch,
                                             remat, rounds):
    before = ssd_scan.launches
    params = _run_three(tmp_path, monkeypatch, arch, remat, rounds)
    jax_trace = (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "vec.jsonl").read_bytes() == jax_trace
    assert (tmp_path / "eager.jsonl").read_bytes() == jax_trace
    init = np.concatenate([np.asarray(w).ravel()
                           for w in jax.tree_util.tree_leaves(params["init"])])
    want = jax.tree_util.tree_leaves(params["jax"])
    want_update = np.concatenate([np.asarray(w).ravel()
                                  for w in want]) - init
    for name in ("vec", "eager"):
        got = tree_leaves(params[name])
        assert len(got) == len(want)
        for a, w in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)
        update = np.concatenate([a.numpy().ravel() for a in got]) - init
        assert (np.linalg.norm(update - want_update)
                <= UPDATE_REL_L2 * np.linalg.norm(want_update))
    assert ssd_scan.launches == before        # no CPU launch
