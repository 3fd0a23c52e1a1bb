"""One torch thread for a test module's tests: the fixture, and a test of
it.  The Tier-1 command runs six pytest workers on the machine's cores,
and each worker's torch thread pool spans all of them: oversubscribed,
torch's CPU kernels ran tens of times slower than alone (bf16
convolutions ~100x).  A module imports the fixture to use it; the thread
count is restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
