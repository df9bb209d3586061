"""The CUDA kernels against their plain versions, on the card.

No JAX here: this file runs on the GPU machine
(``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``)
and skips where there is no card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.compress import (int8_decode, int8_decode_plain,
                                          int8_encode, int8_encode_plain,
                                          topk_decode, topk_encode, topk_mask,
                                          topk_mask_plain, topk_select)
from repro_torch.kernels.fed_agg import (APPLY_OPTS, fed_agg, fed_agg_apply,
                                         fed_agg_apply_plain, fed_agg_plain)
from repro_torch.kernels.flash_attention import (bf16_bound,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

HYPER = (0.1, 0.8, 0.9, 0.99, 1e-3)          # lr, mix, b1, b2, eps
BF16_ULP = 2.0 ** -7                          # bf16 keeps 8 significant bits


def _inputs(K, P, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, P)).astype(np.float32),
            rng.random(K).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    u, c = _inputs(8, 100_003, seed=5)
    u_d = torch.from_numpy(u).to("cuda", dtype)
    c_d = torch.from_numpy(c).cuda()
    before = fed_agg.launches
    got = fed_agg(u_d, c_d)
    torch.cuda.synchronize()
    assert fed_agg.launches == before + 1
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=BF16_ULP, atol=1e-6))
    torch.testing.assert_close(got, fed_agg_plain(u_d, c_d), **tol)
    P = u.shape[1]
    g, m, v = (torch.rand(P, device="cuda") for _ in range(3))
    for opt in APPLY_OPTS:
        got = fed_agg_apply(u_d, c_d, g, m, v, *HYPER, opt=opt)
        want = fed_agg_apply_plain(u_d, c_d, g, m, v, *HYPER, opt=opt)
        torch.cuda.synchronize()
        for t, w in zip(got[:3], want[:3]):
            torch.testing.assert_close(t, w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [8, 256])
def test_compress_kernels_match_plain_on_card(chunk):
    """The codec kernels equal their plain versions bit for bit, on a
    ragged length, an all-zero chunk and a tie-heavy vector."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(6)
    P = 100_003
    x = rng.normal(size=P).astype(np.float32) * rng.uniform(0.01, 10, P)
    x[:2 * chunk] = 0.0
    ties = rng.integers(-3, 4, size=P).astype(np.float32)
    for host in (x.astype(np.float32), ties):
        x_d = torch.from_numpy(host).cuda()
        before = (int8_encode.launches, int8_decode.launches,
                  topk_mask.launches)
        q, s = int8_encode(x_d, chunk)
        q_w, s_w = int8_encode_plain(x_d, chunk)
        out = int8_decode(q, s, P)
        torch.cuda.synchronize()
        assert torch.equal(q, q_w) and torch.equal(s, s_w)
        assert torch.equal(out, int8_decode_plain(q_w, s_w, P))
        for k in (1, 1000):
            idx, tau, last_keep = topk_select(x_d, k)
            got = topk_mask(x_d, tau, last_keep)
            torch.cuda.synchronize()
            assert torch.equal(got, topk_mask_plain(x_d, tau, last_keep))
            i32, vals, decoded = topk_encode(x_d, k)
            assert torch.equal(i32.long(), idx)
            assert torch.equal(decoded, got)
            assert torch.equal(topk_decode(i32, vals, P), got)
        assert (int8_encode.launches, int8_decode.launches,
                topk_mask.launches) == tuple(b + n for b, n in
                                             zip(before, (1, 1, 4)))


@pytest.mark.cuda
def test_experiment_runs_on_card(tmp_path):
    """A small FedLesScan run on the card goes through fed_agg and writes
    the same virtual-time trace as the same run on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.data import label_sorted_shards, make_image_classification
    from repro_torch.fl import experiment
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.models.small import make_cnn

    full = make_image_classification(300, 14, 5, seed=0)
    parts = label_sorted_shards(full, 4, 2)
    traces = {}
    for device in ("cpu", "cuda"):
        task = ClassificationTask(make_cnn(14, 1, 5, 32),
                                  TaskConfig(epochs=1, batch_size=32),
                                  device=device)
        cfg = experiment.ExperimentConfig(
            strategy="fedlesscan", n_rounds=2, clients_per_round=3,
            trace_path=str(tmp_path / f"{device}.jsonl"),
            scenario=experiment.ScenarioConfig(straggler_fraction=0.25))
        before = fed_agg.launches
        params, res = experiment.run_experiment(
            task, parts, None, cfg, initial_params=make_cnn(
                14, 1, 5, 32).init(0), device=device, return_params=True)
        merges = sum(1 for r in res.rounds if r.aggregated_updates)
        assert merges > 0
        assert fed_agg.launches - before == (0 if device == "cpu"
                                             else merges)
        for layer in params.values():
            for leaf in layer.values():
                assert leaf.device.type == device
                assert bool(torch.isfinite(leaf).all())
        traces[device] = (tmp_path / f"{device}.jsonl").read_bytes()
    assert traces["cuda"] == traces["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_on_card(dtype):
    """The kernel against its plain version at head dim 256 with GQA, a
    window, softcap, ragged S and a non-contiguous (swapaxes) input;
    fp32 within 2e-5, bf16 (the tensor-core kernel, p rounded to bf16)
    within bf16_bound: 2^-7·|want| + (2^-8 + 2^-11)·(Σp|v|/l) element by
    element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(7)
    for (B, H, Hkv, S, d, window, cap) in ((2, 8, 4, 129, 256, 64, 50.0),
                                           (1, 2, 2, 1, 256, None, 0.0),
                                           (1, 8, 1, 100, 64, None, 50.0)):
        q = torch.from_numpy(rng.normal(size=(B, S, H, d)).astype(
            np.float32)).to("cuda", dtype).transpose(1, 2)
        k, v = (torch.from_numpy(rng.normal(size=(B, Hkv, S, d)).astype(
            np.float32)).to("cuda", dtype) for _ in range(2))
        before = flash_attention.launches
        got = flash_attention(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = flash_attention_plain(q, k, v, window=window, softcap=cap)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            err = (got.float() - want.float()).abs()
            bound = bf16_bound(q, k, v, want, window=window, softcap=cap)
            assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
def test_flash_attention_refuses_misaligned_bf16_on_card():
    """A bf16 input that the kernel's tensor maps cannot read in place (a
    start off 16 bytes) raises before any launch; nothing is copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    n = 2 * 4 * 16 * 64
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device="cuda")
    q = flat[1:1 + n].view(2, 4, 16, 64)
    k = torch.zeros((2, 2, 16, 64), dtype=torch.bfloat16, device="cuda")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, k)
    assert flash_attention.launches == before


@pytest.mark.cuda
def test_generate_with_kernel_matches_plain_path_on_card():
    """Reduced gemma2-2b served on the card: greedy tokens through the
    kernel equal those of the plain attention path, one launch a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params

    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 80), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    before = flash_attention.launches
    kern = generate(cfg.replace(use_pallas_attention=True), params, prompt, 8)
    assert flash_attention.launches == before + cfg.n_layers
    plain = generate(cfg, params, prompt, 8)
    assert torch.equal(kern.tokens, plain.tokens)
    torch.testing.assert_close(kern.prefill_logits, plain.prefill_logits,
                               rtol=1e-4, atol=1e-4)


# (b, l, h, p, n, broadcast): l = 1; ragged l (129, 300: a partial last
# chunk); odd p (24, 40, 100: a partial p tile, and two p tiles) and n (8,
# 100); a broadcast B/C at n = 100, whose time stride is 200 bytes (copied
# element by element); b = 1; and one full chunk (64 x 2)
SSD_CARD_CASES = ((1, 1, 2, 16, 8, False), (2, 129, 3, 40, 64, True),
                  (2, 300, 4, 64, 128, True), (1, 64, 2, 64, 128, False),
                  (1, 257, 3, 24, 100, True), (1, 200, 2, 100, 16, False),
                  (2, 128, 2, 64, 64, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain_on_card(dtype):
    """The kernel against its plain version, y and the final state, at
    the SSD_CARD_CASES shapes, with contiguous and head-broadcast B and C;
    fp32 within 1e-4, bf16 within one bf16 ulp plus 1e-3 (the state within
    1e-4 for both: the bf16 kernel splits every fp32 operand of its
    products into a bf16 hi and lo pair)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=BF16_ULP, atol=1e-3))
    rng = np.random.default_rng(8)
    for (b, l, h, p, n, broadcast) in SSD_CARD_CASES:
        x = torch.from_numpy(rng.normal(size=(b, l, h, p)).astype(
            np.float32) * 0.5).to("cuda", dtype)
        a = -torch.from_numpy(np.abs(rng.normal(size=(b, l, h))).astype(
            np.float32) * 0.3).cuda()
        B, C = (torch.from_numpy(rng.normal(
            size=(b, l, 1 if broadcast else h, n)).astype(np.float32)
            * 0.5).to("cuda", dtype).expand(b, l, h, n) for _ in range(2))
        before = ssd_scan.launches
        y, state = ssd_scan(x, a, B, C, return_state=True)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        want_y, want_state = ssd_scan_plain(x, a, B, C, return_state=True)
        label = f"{(b, l, h, p, n)} broadcast {broadcast}"
        torch.testing.assert_close(y, want_y, **tol, msg=label)
        torch.testing.assert_close(state, want_state, rtol=1e-4, atol=1e-4,
                                   msg=label)


@pytest.mark.cuda
def test_ssd_scan_bf16_reads_strided_views_in_place():
    """The bf16 kernel on views that models/ssm.py-like callers pass: x, B
    and C cut from one wider buffer (time strides of the buffer, B and C
    at column offsets that are not 16-byte aligned), the result equal to
    that of contiguous copies bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b, l, h, p, n = 2, 300, 3, 40, 36
    g = torch.Generator("cuda").manual_seed(3)
    buf = (torch.randn((b, l, h * p + 2 * n + 1), generator=g,
                       device="cuda") * 0.5).to(torch.bfloat16)
    x = buf[..., :h * p].reshape(b, l, h, p)
    B = buf[:, :, None, h * p + 1:h * p + 1 + n].expand(b, l, h, n)
    C = buf[:, :, None, h * p + 1 + n:].expand(b, l, h, n)
    a = -torch.rand((b, l, h), generator=g, device="cuda") * 0.3
    y, state = ssd_scan(x, a, B, C, return_state=True)
    y2, state2 = ssd_scan(x.contiguous(), a, B.contiguous(), C.contiguous(),
                          return_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.cuda
def test_mamba_models_generate_on_card_as_on_cpu():
    """Reduced mamba2-130m and zamba2-1.2b served on the card (the scan
    in the kernel, one launch a Mamba layer) give the greedy tokens and
    prefill logits of the same params served on the CPU (plain
    versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params

    for arch in ("mamba2-130m", "zamba2-1.2b"):
        cfg = get_config(arch).reduced().replace(use_pallas_attention=True)
        params = init_params(cfg, torch.Generator("cuda").manual_seed(0))
        prompt = torch.randint(0, cfg.vocab, (2, 100), device="cuda",
                               generator=torch.Generator("cuda")
                               .manual_seed(1))
        before = ssd_scan.launches
        card = generate(cfg, params, prompt, 8)
        assert ssd_scan.launches == before + cfg.n_layers
        cpu = generate(cfg, tree_map(lambda t: t.cpu(), params),
                       prompt.cpu(), 8)
        assert torch.equal(card.tokens.cpu(), cpu.tokens)
        torch.testing.assert_close(card.prefill_logits.cpu(),
                                   cpu.prefill_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_sharded_kernels_match_unsharded_on_card():
    """fed_agg_sharded and fed_agg_apply_sharded on a two-slot mesh of the
    one card equal the unsharded kernels bit for bit (out, m, v), the norm
    within 1e-6; P odd, so the slabs are padded and their row stride is
    the padded width, not their own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.fed_agg import (fed_agg_apply_sharded,
                                             fed_agg_sharded)
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(("cuda:0", "cuda:0"), (("data", 2), ("model", 1)))
    u, c = _inputs(8, 100_003, seed=9)
    c_d = torch.from_numpy(c).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        u_d = torch.from_numpy(u).to("cuda", dtype)
        before = (fed_agg.launches, fed_agg_sharded.launches)
        got = fed_agg_sharded(u_d, c_d, mesh)
        torch.cuda.synchronize()
        assert (fed_agg.launches, fed_agg_sharded.launches) == (
            before[0] + 2, before[1] + 1)
        assert torch.equal(got, fed_agg(u_d, c_d))
    u_d = torch.from_numpy(u).cuda()
    P = u.shape[1]
    g, m, v = (torch.rand(P, device="cuda") for _ in range(3))
    for opt in APPLY_OPTS:
        got = fed_agg_apply_sharded(u_d, c_d, g, m, v, *HYPER, opt=opt,
                                    mesh=mesh)
        want = fed_agg_apply(u_d, c_d, g, m, v, *HYPER, opt=opt)
        torch.cuda.synchronize()
        for t, w in zip(got[:3], want[:3]):
            assert torch.equal(t, w), opt
        torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
def test_executor_matches_local_train_on_card():
    """VectorizedExecutor.run_group on the card against each client's
    eager local_train, TF32 off.  Local SGD, so that the comparison reads
    the batched convolutions' fp32 rounding and not Adam's amplification
    of it (ROADMAP Queue 3); within 1e-4, since cuDNN picks other
    algorithms for the grouped convolutions vmap makes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.data import make_image_classification
    from repro_torch.data.synthetic import ArrayDataset
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.models.small import make_cnn

    full = make_image_classification(160, 14, 4, seed=0)
    parts = {f"c{i}": ArrayDataset(full.x[i * 20:(i + 1) * 20],
                                   full.y[i * 20:(i + 1) * 20])
             for i in range(8)}
    task = ClassificationTask(
        make_cnn(14, 1, 4, 8, "tiny"),
        TaskConfig(epochs=2, batch_size=8, optimizer="sgd",
                   learning_rate=0.05), device="cuda")
    pool = ClientPool(task, parts, None, seed=0)
    params = task.init_params(0)
    cids = [f"c{i}" for i in range(5)]
    seeds = [pool.client_seed(cid, 0) for cid in cids]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = VectorizedExecutor(task).run_group(
            cids, [parts[c] for c in cids], params, 0.0, seeds)
        for cid, seed in zip(cids, seeds):
            want, want_loss = task.local_train(params, parts[cid], seed=seed)
            assert abs(got[cid][1] - want_loss) < 1e-4
            for a, b in zip(tree_leaves(got[cid][0]), tree_leaves(want)):
                assert a.device.type == "cuda"
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("P", [818_402, 67_267])
def test_fed_agg_at_the_small_models_widths_on_card(P):
    """The char-LSTM's and the speech CNN's merges (K = 8, ragged P), bit
    for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    u, c = _inputs(8, P, seed=11)
    u_d, c_d = torch.from_numpy(u).cuda(), torch.from_numpy(c).cuda()
    before = fed_agg.launches
    got = fed_agg(u_d, c_d)
    torch.cuda.synchronize()
    assert fed_agg.launches == before + 1
    assert torch.equal(got, fed_agg_plain(u_d, c_d))


@pytest.mark.cuda
def test_lstm_executor_matches_local_train_on_card():
    """The char-LSTM (reduced width, int32 tokens, a partial last batch)
    through VectorizedExecutor.run_group on the card against each client's
    eager local_train, with Table I's local SGD at lr 0.8: within 1e-4, the
    bound of the CNN's card test (the batched matmuls may sum in another
    order than the eager ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.data import make_char_lm
    from repro_torch.data.synthetic import ArrayDataset
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.models.small import make_char_lstm

    full = make_char_lm(8 * 19, seq_len=12, vocab=20, seed=0)
    parts = {f"c{i}": ArrayDataset(full.x[i * 19:(i + 1) * 19],
                                   full.y[i * 19:(i + 1) * 19])
             for i in range(8)}
    task = ClassificationTask(
        make_char_lstm(20, 4, 16),
        TaskConfig(epochs=1, batch_size=8, optimizer="sgd",
                   learning_rate=0.8), device="cuda")
    pool = ClientPool(task, parts, None, seed=0)
    params = task.init_params(0)
    cids = [f"c{i}" for i in range(5)]
    seeds = [pool.client_seed(cid, 0) for cid in cids]
    got = VectorizedExecutor(task).run_group(
        cids, [parts[c] for c in cids], params, 0.0, seeds)
    for cid, seed in zip(cids, seeds):
        want, want_loss = task.local_train(params, parts[cid], seed=seed)
        assert abs(got[cid][1] - want_loss) < 1e-4
        for a, b in zip(tree_leaves(got[cid][0]), tree_leaves(want)):
            assert a.device.type == "cuda"
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_checkpoint_of_card_tensors_restores_on_card(tmp_path):
    """A run on the card checkpoints its tensors (one host copy a dtype)
    and a resumed run gets them back on the card, replaying the rounds of
    the uninterrupted run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.data import label_sorted_shards, make_char_lm
    from repro_torch.data.synthetic import ArrayDataset
    from repro_torch.fl import experiment
    from repro_torch.fl.checkpointing import RoundCheckpointer
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.models.small import make_char_lstm

    full = make_char_lm(200, seq_len=12, vocab=20, seed=0)
    parts = label_sorted_shards(ArrayDataset(full.x, full.y), 8, 2, seed=0)
    task = ClassificationTask(
        make_char_lstm(20, 4, 16),
        TaskConfig(epochs=1, batch_size=8, optimizer="sgd",
                   learning_rate=0.8, per_sample_time_s=0.05),
        device="cuda")

    def cfg(**kw):
        return experiment.ExperimentConfig(
            strategy="fedlesscan", clients_per_round=4, eval_every=0,
            scenario=experiment.ScenarioConfig(straggler_fraction=0.3,
                                               round_timeout_s=12.0),
            **kw)

    init = task.init_params(0)
    ref_params, ref = experiment.run_experiment(
        task, parts, None, cfg(n_rounds=3), initial_params=init,
        device="cuda", return_params=True)
    ckdir = str(tmp_path / "ck")
    experiment.run_experiment(task, parts, None,
                              cfg(n_rounds=2, checkpoint_dir=ckdir,
                                  checkpoint_every=1), initial_params=init,
                              device="cuda")
    restored = {}
    restore = RoundCheckpointer.restore

    def keep(self, driver, like, round_number=None):
        out = restore(self, driver, like, round_number)
        restored["params"] = out[0]
        return out

    RoundCheckpointer.restore = keep
    try:
        params, tail = experiment.run_experiment(
            task, parts, None, cfg(n_rounds=3, resume_from=ckdir),
            initial_params=init, device="cuda", return_params=True)
    finally:
        RoundCheckpointer.restore = restore
    assert all(t.device.type == "cuda"
               for t in tree_leaves(restored["params"]))
    assert [r.selected for r in tail.rounds] == \
        [r.selected for r in ref.rounds[2:]]
    for a, b in zip(tree_leaves(params), tree_leaves(ref_params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_grads_match_plain_on_card(dtype):
    """Under autograd the scan's forward launches the kernel and its
    backward is the plain version's: the grads of x, a_dt and the
    head-broadcast B/C views' bases (summed over heads by autograd) equal
    those of autograd through ssd_scan_plain within 1e-5 of each max
    |grad| (the same fp32 graph on the same inputs), also under
    torch.utils.checkpoint, which relaunches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    b, l, h, p, n = 2, 300, 4, 64, 64
    g = torch.Generator("cuda").manual_seed(9)
    leaves = [(torch.randn((b, l, h, p), generator=g, device="cuda")
               * 0.5).to(dtype),
              -torch.rand((b, l, h), generator=g, device="cuda") * 0.3,
              *((torch.randn((b, l, 1, n), generator=g, device="cuda")
                 * 0.5).to(dtype) for _ in range(2))]
    for t in leaves:
        t.requires_grad_(True)
    gy = torch.randn((b, l, h, p), generator=g, device="cuda").to(dtype)

    def scan(fn, x, a, Bb, Cb):
        return fn(x, a, Bb.expand(b, l, h, n), Cb.expand(b, l, h, n))

    want = torch.autograd.grad(scan(ssd_scan_plain, *leaves), leaves, gy)
    for remat in (False, True):
        before = ssd_scan.launches
        y = (torch.utils.checkpoint.checkpoint(
            scan, ssd_scan, *leaves, use_reentrant=False) if remat
            else scan(ssd_scan, *leaves))
        got = torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1 + remat
        for name, t, w in zip(("x", "a_dt", "B", "C"), got, want):
            assert t.dtype == w.dtype and t.shape == w.shape
            scale = float(w.float().abs().max())
            assert scale > 0
            torch.testing.assert_close(t, w, rtol=0, atol=1e-5 * scale,
                                       msg=f"{name} remat {remat}")


@pytest.mark.cuda
def test_flash_attention_refuses_autograd_on_card():
    """flash_attention has no backward: with an input that requires grad
    it raises before any launch, as the JAX package's Pallas kernel
    cannot be differentiated; under no_grad it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    q, k, v = (torch.randn(1, 2, 64, 64, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="flash_attention has no "
                                           "backward"):
        flash_attention(q.requires_grad_(True), k, v)
    assert flash_attention.launches == before
    with torch.no_grad():
        flash_attention(q, k, v)
    assert flash_attention.launches == before + 1


@pytest.mark.cuda
def test_mamba_train_step_on_card_as_on_cpu():
    """One make_train_step step of reduced mamba2-130m (fp32) on the card,
    the scan's forward in the kernel, against the same step on the CPU:
    the loss within 1e-5 relative, the Adam moments within 1e-4 relative
    L2, and one launch a layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map, tree_paths
    from repro_torch.models import make_train_step

    cfg = get_config("mamba2-130m").reduced().replace(efficient_ce=True)
    step, init_state = make_train_step(cfg)
    state = init_state(torch.Generator("cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 2, 256), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    batch = {"tokens": tok[0], "labels": tok[1]}
    cpu_state = {"params": tree_map(lambda t: t.cpu(), state["params"]),
                 "opt": {"count": 0, **{k: tree_map(lambda t: t.cpu(), v)
                                        for k, v in state["opt"].items()
                                        if k != "count"}}}
    before = ssd_scan.launches
    card, loss = step(state, batch)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + cfg.n_layers
    cpu, cpu_loss = step(cpu_state, {k: t.cpu() for k, t in batch.items()})
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for key in ("m", "v"):
        for path, t in tree_paths(card["opt"][key]):
            w = cpu["opt"][key]
            for part in path:
                w = w[part]
            rel = float((t.cpu() - w).norm() / w.norm().clamp(min=1e-30))
            assert rel <= 1e-4, (key, path, rel)


@pytest.mark.cuda
def test_executor_step_of_mamba_on_card_matches_plain_scan(monkeypatch):
    """One vectorized-executor step of reduced mamba2-130m (fp32, 4
    clients, federated_pretrain's ModelDef) on the card: the scan in the
    kernel under its vmap rule, one folded launch a layer, against the
    same step with the scan in ssd_scan_plain under vmap: the losses
    within 1e-5 relative and every leaf's grads within 1e-4 relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from torch.func import grad_and_value, vmap

    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map, tree_paths
    from repro_torch.examples import federated_pretrain
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask
    from repro_torch.models import ssm

    cfg = get_config("mamba2-130m").reduced().replace(vocab=256)
    task = ClassificationTask(federated_pretrain.cfg_as_model(cfg, "lm"),
                              federated_pretrain.TASK, device="cuda")
    params = task.init_params(0)
    K = 4
    stacked = tree_map(lambda t: t.unsqueeze(0).expand(K, *t.shape).clone(),
                       params)
    g = torch.Generator("cuda").manual_seed(3)
    x = torch.randint(0, 256, (K, 16, 32), generator=g, device="cuda")
    y = torch.randint(0, 256, (K, 16), generator=g, device="cuda")
    m = torch.ones((K, 16), device="cuda")
    step = vmap(grad_and_value(VectorizedExecutor(task)._masked_loss))
    before = ssd_scan.launches
    grads, losses = step(stacked, x, y, m)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + cfg.n_layers
    monkeypatch.setattr(ssm, "ssd_scan", ssd_scan_plain)
    want_grads, want_losses = step(stacked, x, y, m)
    assert ssd_scan.launches == before + cfg.n_layers
    torch.testing.assert_close(losses, want_losses, rtol=1e-5, atol=0)
    for (path, t), (_, w) in zip(tree_paths(grads), tree_paths(want_grads)):
        rel = float((t - w).norm() / w.norm().clamp(min=1e-30))
        assert rel <= 1e-4, (path, rel)


# ------------------------------------------------------------------ adam
ADAM = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _bias_corrections(count):
    return {f"bc{i}": float(np.float32(1) - np.float32(b) ** np.float32(
        count)) for i, b in ((1, ADAM["b1"]), (2, ADAM["b2"]))}


def _adam_inputs(shapes, dtype, seed):
    """params, grads, moments (v ≥ 0) and the anchor (a stacked leaf's
    first row) on the card, from numpy."""
    rng = np.random.default_rng(seed)

    def draw(shape, scale, dt):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).to("cuda", dt)

    p = [draw(s, 1.0, dtype) for s in shapes]
    g = [draw(s, 0.01, dtype) for s in shapes]
    m = [draw(s, 1e-3, torch.float32) for s in shapes]
    v = [draw(s, 3e-3, torch.float32).square() for s in shapes]
    a = [t[0].clone() if t.dim() > 1 else t.clone() for t in p]
    return p, g, m, v, a


def _femnist_shapes(k=64):
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.models.small import make_cnn
    return [(k, *t.shape) for t in
            tree_leaves(make_cnn(28, 1, 62, 2048, "femnist_cnn").init(0))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["femnist_k64", "ragged_prox_wd",
                                  "bf16_prox_wd", "many_leaves"])
def test_adam_matches_plain_on_card(case):
    """kernels.adam bit for bit against its plain version (PyTorch's
    unfused passes) on the card, three steps from one state, the step and
    the update alone; one launch a table of MAX_LEAVES leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.adam import MAX_LEAVES, adam, adam_plain

    dtype, extra = torch.float32, {}
    if case == "femnist_k64":          # the 62- and 2048x62-element leaves
        shapes = _femnist_shapes()
        assert (64, 62) in shapes and (64, 2048, 62) in shapes
    elif case == "ragged_prox_wd":     # lengths not a multiple of 4
        shapes = [(5, 1001), (3,), (7, 3, 3), (2, 4097)]
        extra = dict(mu=0.01, weight_decay=0.01)
    elif case == "bf16_prox_wd":
        shapes = [(8, 62), (8, 1001), (8, 64, 62)]
        dtype, extra = torch.bfloat16, dict(mu=0.01, weight_decay=0.01)
    else:                              # more leaves than one table holds
        shapes = [(4, 5 + i) for i in range(2 * MAX_LEAVES + 9)]
    p, g, m, v, a = _adam_inputs(shapes, dtype, seed=len(case))
    kw = dict(ADAM, weight_decay=extra.get("weight_decay", 0.0),
              anchor=a, mu=extra.get("mu", 0.0))
    for count in (1, 2, 3):
        for apply in (False, True):
            before = adam.launches
            got = adam(p, g, m, v, apply=apply, **kw,
                       **_bias_corrections(count))
            assert adam.launches - before == -(-len(shapes) // MAX_LEAVES)
            want = adam_plain(p, g, m, v, apply=apply, **kw,
                              **_bias_corrections(count))
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                for s, t in zip(x, y):
                    assert s.dtype == t.dtype and s.shape == t.shape
                    assert torch.equal(s, t), (case, count, apply,
                                               tuple(s.shape))
        p, m, v = got
        assert all(t.dtype == dtype for t in p)


@pytest.mark.cuda
def test_adam_refuses_what_its_kernel_does_not_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels.adam import adam

    h = torch.zeros(4, 8, device="cuda", dtype=torch.float16)
    f = torch.zeros(4, 8, device="cuda")
    with pytest.raises(TypeError, match="adam's kernel takes"):
        adam([h], [h], [f], [f], weight_decay=0.0, bc1=0.1, bc2=0.001,
             **ADAM)


@pytest.mark.cuda
def test_host_scalar_division_is_a_reciprocal_product_on_card():
    """The kernel takes m / bc1 as m · fp32(1 / bc1), the reciprocal taken
    in double, as PyTorch's CUDA true division by a CPU scalar computes it
    (for 0.001 the fp32 reciprocal of fp32(0.001) is 999.99994, and the
    quotients differ); fp32 scalars in products, bf16 · scalar rounded
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=1 << 20).astype(np.float32)).cuda()
    scalars = [0.1, 0.001, 0.3] + [bc for count in (1, 2, 3, 7, 1000)
                                   for bc in _bias_corrections(count).values()]
    for bc in scalars:
        assert torch.equal(x / bc, x * float(np.float32(1.0 / bc)))
    assert not torch.equal(x / 0.001,
                           x * float(np.float32(1) / np.float32(0.001)))
    assert torch.equal(0.9 * x, x * float(np.float32(0.9)))
    xb = x.to(torch.bfloat16)
    assert torch.equal(0.01 * xb,
                       (xb.float() * float(np.float32(0.01))).bfloat16())


@pytest.mark.cuda
def test_executor_launches_adam_once_a_step_on_card():
    """VectorizedExecutor._train_group on the card (deterministic cuDNN,
    TF32 off, FedProx on): one adam launch a local step, and the rows the
    plain passes give when applied by hand in the optimizer's place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.core.flatten import tree_leaves, tree_map
    from repro_torch.data import make_image_classification
    from repro_torch.data.synthetic import ArrayDataset
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.kernels.adam import adam, adam_plain
    from repro_torch.models.small import make_cnn
    from repro_torch.optim import Optimizer

    full = make_image_classification(100, 14, 4, seed=0)
    parts = [ArrayDataset(full.x[i * 20:(i + 1) * 20],
                          full.y[i * 20:(i + 1) * 20]) for i in range(5)]
    task = ClassificationTask(
        make_cnn(14, 1, 4, 8, "tiny"),
        TaskConfig(epochs=2, batch_size=8, optimizer="adam",
                   learning_rate=1e-3), device="cuda")
    params = task.init_params(0)
    cids, seeds = [f"c{i}" for i in range(5)], list(range(5))
    opt = task.optimizer

    def by_hand(grads, state, params):
        count = state["count"] + 1
        out = tree_map(lambda p, g, m, v: adam_plain(
            [p], [g], [m], [v], weight_decay=0.0, apply=False, **ADAM,
            **_bias_corrections(count)), params, grads, state["m"],
            state["v"])
        pick = [tree_map(lambda r: r[i][0], out) for i in range(3)]
        return pick[0], {"count": count, "m": pick[1], "v": pick[2]}

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        rows = {}
        for name, o in (("kernel", opt), ("by_hand", Optimizer(opt.init,
                                                               by_hand))):
            task.optimizer = o
            before = adam.launches
            stacked, losses = VectorizedExecutor(task)._train_group(
                cids, parts, params, 0.01, seeds)
            torch.cuda.synchronize()
            rows[name] = (stacked, losses, adam.launches - before)
    finally:
        task.optimizer = opt
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    steps = 2 * -(-20 // 8)
    assert rows["kernel"][2] == steps and rows["by_hand"][2] == 0
    assert torch.equal(rows["kernel"][1], rows["by_hand"][1])
    for a, b in zip(tree_leaves(rows["kernel"][0]),
                    tree_leaves(rows["by_hand"][0])):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_reads_grouped_b_and_c_in_place_on_card(dtype):
    """Grouped B and C (b, l, g, n), head i reading group i // (h / g)
    (Nemotron-H's 64 heads in 8 groups at a short length): the kernel's y
    and state equal those of B and C expanded to the heads bit for bit
    (the same rows loaded), and the plain version's within
    test_ssd_scan_matches_plain_on_card's tolerances; one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=BF16_ULP, atol=1e-3))
    g = torch.Generator("cuda").manual_seed(5)
    for (b, l, h, p, n, groups) in ((2, 300, 8, 64, 128, 2),
                                    (1, 1024, 64, 64, 128, 8),
                                    (2, 129, 6, 16, 36, 3)):
        x = (torch.randn((b, l, h, p), generator=g, device="cuda")
             * 0.5).to(dtype)
        a = -torch.rand((b, l, h), generator=g, device="cuda") * 0.3
        B, C = ((torch.randn((b, l, groups, n), generator=g, device="cuda")
                 * 0.5).to(dtype) for _ in range(2))
        before = ssd_scan.launches
        y, state = ssd_scan(x, a, B, C, return_state=True)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 1
        r = h // groups
        y2, state2 = ssd_scan(x, a, B.repeat_interleave(r, 2),
                              C.repeat_interleave(r, 2), return_state=True)
        assert torch.equal(y, y2) and torch.equal(state, state2)
        want_y, want_state = ssd_scan_plain(x, a, B, C, return_state=True)
        label = f"{(b, l, h, p, n, groups)}"
        torch.testing.assert_close(y, want_y, **tol, msg=label)
        torch.testing.assert_close(state, want_state, rtol=1e-4, atol=1e-4,
                                   msg=label)


@pytest.mark.cuda
def test_hybrid_train_step_on_card_as_on_cpu():
    """One make_train_step step of Nemotron-H at a small size (pattern
    ``MEM*E``, grouped B/C, 8 experts top 2 with 4 held, fp32) on the card
    (the grouped scan in the kernel, the dropless MoE, SDPA attention, the
    chunked CE, remat block by block) against the same step on the CPU:
    the loss within 1e-5 relative, the first moment within 2e-4 and the
    second within 4e-4 relative L2 (v holds g², so its gap is twice g's;
    the card's fp32 SDPA and grouped products sum in other orders than
    the CPU's, and the Mamba dt_bias gradient, a sum over every position,
    reads 5.6e-5 apart); the MoE layers route the same pairs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch import tracing
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map, tree_paths
    from repro_torch.models import make_train_step

    cfg = get_config("nemotron-3-nano-30b-a3b").replace(
        n_layers=5, pattern=("mamba", "moe", "mamba", "attn_only", "moe"),
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=64,
        vocab=256, n_experts=8, top_k=2, held_experts=4,
        shared_expert_ff=96, ssm_state=32, ssm_head_dim=32, ssm_n_heads=4,
        ssm_groups=2, ce_chunk=128, dtype="float32")
    step, init_state = make_train_step(cfg)
    state = init_state(torch.Generator("cuda").manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (2, 2, 256), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))
    batch = {"tokens": tok[0], "labels": tok[1]}
    cpu_state = {"params": tree_map(lambda t: t.cpu(), state["params"]),
                 "opt": {"count": 0, **{k: tree_map(lambda t: t.cpu(), v)
                                        for k, v in state["opt"].items()
                                        if k != "count"}}}
    tracing.drain()
    tracing.enable()
    try:
        before = ssd_scan.launches
        card, loss = step(state, batch)
        torch.cuda.synchronize()
        assert ssd_scan.launches == before + 2 * 2     # forward and remat
        _, card_counts = tracing.drain()
        cpu, cpu_loss = step(cpu_state,
                             {k: t.cpu() for k, t in batch.items()})
        _, cpu_counts = tracing.drain()
    finally:
        tracing.enable(False)
    assert card_counts == cpu_counts
    torch.testing.assert_close(loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for key in ("m", "v"):
        for path, t in tree_paths(card["opt"][key]):
            w = cpu["opt"][key]
            for part in path:
                w = w[part]
            if w.norm() == 0:
                assert t.norm() == 0, (key, path)
                continue
            rel = float((t.cpu() - w).norm() / w.norm())
            assert rel <= {"m": 2e-4, "v": 4e-4}[key], (key, path, rel)
