"""An autouse fixture for the port's CPU test modules whose torch ops are
small: one intra-op thread in the test process and in any rank it spawns
(which inherit OMP_NUM_THREADS).  Under a parallel test run every worker
process would otherwise start a thread a core, the workers together
oversubscribe the cores, and each small op waits on its threads'
scheduling: tests/test_torch_parallel.py took ~670 s so against ~60 s
alone.  A module takes it with

    from torch_threads import one_intra_op_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(threads)
