"""Fixtures of the benchmark's tests; imports no JAX.

``cuda``: the card, for the tests marked ``gpu``, which skip without one
(decided here, when a test asks, never while the module is imported).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def data_dir() -> Path:
    return DATA
