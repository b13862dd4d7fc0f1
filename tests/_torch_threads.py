"""The port's CPU test files' module-scoped one-thread fixture: beside
the suite's other workers, torch's default intra-op pool oversubscribes
the cores and its many tiny ops spin, tens of times slower (a file took
1054 s in the suite against 31 s alone).  A test file takes it with one
line, ``from _torch_threads import one_thread  # noqa: F401``."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread while the module's tests run."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
