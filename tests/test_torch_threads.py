"""The test processes' CPU thread budget: one torch intra-op thread, set
by the repository's root ``conftest.py``, and ranks spawned by
``parallel.run_ranks`` that split it rather than the machine's cores."""
import torch

from lsd_tpu_torch.parallel import run_ranks
from tests import torch_ranks


def test_a_test_process_has_one_torch_thread():
    assert torch.get_num_threads() == 1


def test_spawned_ranks_split_the_parents_threads():
    assert run_ranks(torch_ranks.num_threads, 2, backend="gloo") == [1, 1]
