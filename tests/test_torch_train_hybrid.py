"""The port's loss and gradients against the JAX package's for the two
reduced configs with the most blocks: gemma3-1b (five local blocks to a
global one) and zamba2-1.2b (six Mamba2 blocks and the weight-tied shared
attention block, whose gradient sums over its uses).  The method and the
tolerances are tests/test_torch_train_step.py's."""
import pytest
import torch

from torch_parity_common import check_loss_and_grads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("efficient_ce", [False, True])
@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b"])
def test_loss_and_grads_match_reference(arch, efficient_ce):
    check_loss_and_grads(arch, efficient_ce)
