"""The benchmark's own tests: on the CPU at small sizes, and (marked
``cuda``) on the card at the cells' sizes.  Run from the root of the
checkout: ``python -m pytest iqbench/tests -q`` (``-m cuda`` on the card)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
