"""A module fixture for the port's test files (not a test module): two
torch intra-op threads while the module runs, the count before restored
after.  The driver runs the suite over six workers on one host; each
worker's torch defaults to a thread per core, and the oversubscribed
threads made a port file's eager torch ops several times slower than
two threads a worker (``tests/test_torch_trainer.py``: 297 s of worker
time at the default, 58 s at two threads)."""
import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
