"""The port's test files share one fixture: import it by name
(``from torch_one_thread import one_torch_thread``) and pytest applies it
to every case of the importing module."""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for these cases: their many small torch ops
    slow down by two orders of magnitude when the thread pools of parallel
    test workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
