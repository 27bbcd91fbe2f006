"""The CPU's cores shared among the port's test processes.

Under pytest-xdist each worker process would run torch's intra-op pool
on every core of the machine, so 6 workers on 8 cores run 48 threads,
and the port's small CPU ops spend most of their time waiting on one
another (six of the port's test files on 6 workers of an 8-core CPU took
278 s so, 100 s with one thread a worker).  `torch_threads` gives each module of the
port's tests its worker's share of the cores, torch's pool and, for the
processes a test starts, OMP_NUM_THREADS, and restores both after the
module.  Every ``tests/test_torch_*.py`` module imports it (autouse).
The results are the same at any thread count: the tests compare within
tolerances set by the two packages' own rounding, or bit for bit where
both sides run the same code in one process."""
import os

import pytest
import torch


def share() -> int:
    """This process's share of the cores: all of them in a plain pytest
    run, cores // workers under pytest-xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(workers, 1))


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = share()
    prev, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(n)
    os.environ["OMP_NUM_THREADS"] = str(n)
    try:
        yield n
    finally:
        torch.set_num_threads(prev)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env


def test_each_worker_gets_its_share(torch_threads):
    assert torch.get_num_threads() == torch_threads == share()
    assert os.environ["OMP_NUM_THREADS"] == str(share())
    assert 1 <= share() <= len(os.sched_getaffinity(0))
