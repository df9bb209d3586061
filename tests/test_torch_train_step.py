"""The port's decoder loss and its gradients against the JAX package's.

For the reduced configs of five archs of the zoo (gemma2-2b's local and
global blocks with softcaps, chatglm3-6b's partial RoPE, internlm2-20b's
GQA, mamba2-130m, musicgen-medium's codebooks; gemma3-1b and
zamba2-1.2b are in tests/test_torch_train_hybrid.py), params made by the
JAX package are carried into the port, the same numpy batch goes through
both, and the port's ``grads_of`` (``loss_fn`` under autograd, the scan's
backward the plain version's) is held against ``jax.value_and_grad`` of
the reference's ``loss_fn``, with both cross-entropy forms.  Reduced
configs compute in fp32 with remat off.  Tolerances
(tests/torch_parity_common.py): the loss within LOSS_RTOL = 1e-5
relative, every leaf's gradient within GRAD_REL_L2 = 1e-4 relative L2.
"""
import pytest
import torch

from torch_parity_common import check_loss_and_grads

ARCHS = ("gemma2-2b", "chatglm3-6b", "internlm2-20b", "mamba2-130m",
         "musicgen-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("efficient_ce", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, efficient_ce):
    check_loss_and_grads(arch, efficient_ce)

