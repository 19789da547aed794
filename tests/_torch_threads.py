"""A fixture the port's test files import by name: torch on one intra-op
thread for the whole module.

    from _torch_threads import _one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the importing file: the suite's workers
    share the CPU, and torch's default pool (a thread a core in every
    worker) spends more time contending than computing at these tiny
    shapes. On one thread torch's CPU ``exp`` is exact from the first
    call (``test_torch_cpu_exp.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
