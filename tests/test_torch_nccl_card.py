"""NCCL worlds of the port on the card (marked ``gpu``; skips without
CUDA). On a machine with an NVIDIA card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_nccl_card.py
"""
import pytest
import torch

from brpc_tpu_torch.parallel.world import launch, run_ranks
import torch_spmd_ranks  # tests/ is on sys.path (rootdir insertion)

pytestmark = pytest.mark.gpu

DEADLINE_S = 120.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")


def test_psum_over_every_card(card):
    n = torch.cuda.device_count()
    got = run_ranks(torch_spmd_ranks.psum_rank, n, deadline_s=DEADLINE_S)
    assert got == [float(n * (n + 1) // 2)] * n


def test_more_ranks_than_cards_raises(card):
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="one per rank"):
        run_ranks(torch_spmd_ranks.psum_rank, n + 1, deadline_s=DEADLINE_S)


def test_two_ranks_on_one_card_are_refused(card):
    """NCCL refuses two ranks of one communicator on one card, which is
    why run_ranks gives every rank a card of its own."""
    with pytest.raises((RuntimeError, TimeoutError)) as err:
        launch(torch_spmd_ranks.psum_rank, (), "nccl", ["cuda:0", "cuda:0"],
               DEADLINE_S)
    print(f"two NCCL ranks on cuda:0: {type(err.value).__name__}: "
          f"{str(err.value)[-800:]}")
    assert "Duplicate GPU" in str(err.value)
