"""CPU tests of the benchmark (``python -m pytest benchmark/tests``).

They run the harness at tiny sizes with the port's plain CPU versions: a
time or rate measured here says nothing about the card.  Tests that need
the card carry the ``cuda`` marker and skip without one, decided inside a
fixture."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
