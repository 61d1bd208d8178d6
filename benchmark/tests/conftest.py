"""The benchmark's own tests: on the CPU at a tiny size, and (marked
``cuda``) one real run of each cell on a card.

    python3 -m pytest benchmark/tests -q
"""

import pytest
import torch

# every cell at a size a CPU test holds: the shapes shrink, the code paths
# are the runs'.  The same for every cell, so a new cell needs no entry here
SMALL_CFG = dict(width=64, height=48, platesize=48, pano_h=64, pano_w=128)
SMALL_MIX = dict(batch=4)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda")
