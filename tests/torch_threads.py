"""One thread for the port's parity tests.

The tier-1 run starts several xdist workers on one host, and each would
give torch's intra-op pool and numpy's BLAS every core of the host: the
pools then oversubscribe the cores many times over, and a small product
waits for threads that other workers keep busy. The port's test modules
import :func:`one_thread`, an autouse fixture: while a module's tests run,
torch and the BLAS and OpenMP libraries that threadpoolctl finds use one
thread, and the counts come back after the module. The rank processes of
the distributed tests run one thread each too (``parallel.driver.launch``
on the CPU).
"""
import contextlib

import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # torch's pool alone
    threadpool_limits = None


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with (threadpool_limits(limits=1) if threadpool_limits
          else contextlib.nullcontext()):
        yield
    torch.set_num_threads(threads)
