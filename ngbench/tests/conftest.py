"""Fixtures of the benchmark's own tests: the repository root on the path,
a tiny copy of the benchmark, and the card where a test needs one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny copy's ngbench directory."""
    from ngbench.tests.tiny import make_copy
    return make_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """The first CUDA device; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """One CPU thread a test process: the tiny runs gain nothing from more,
    and workers that each take every core slow each other's windows."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
