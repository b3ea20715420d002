"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q
-p no:cacheprovider`` from the repo root.  Tests marked ``gpu`` need a
CUDA card and skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
