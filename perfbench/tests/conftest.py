"""The harness's own tests. Most run on the CPU at test widths; those
marked `gpu` run the real cells on a CUDA card and skip elsewhere (the
decision is made inside the fixture, never at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run on the H100 only")
    return "cuda"
