"""The benchmark's tests run from the repository's root:

    python -m pytest benchmark/tests -q

Tests that need the card carry the ``cuda`` marker and skip where none is
visible (run them on the card with ``-m cuda``)."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
