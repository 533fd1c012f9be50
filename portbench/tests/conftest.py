"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
root of the repo.  They run on the CPU at small sizes; a test marked `cuda`
decides inside itself whether a card is present."""
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PORTBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PORTBENCH)
for path in (PORTBENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
