"""On the card: a short run of each cell through the harness, correct
against its limits.  Skips without a card (decided inside the test)."""
import pytest
import torch

import run

CELLS = ["cornell.progressive", "cornell.interactive"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result, _ = run.run(workload, 2**31 + 99, 2.0, False)
    assert result["correct"] and result["failed"] == 0, result["check"]
    assert result["device"]["platform"] == "gpu" and result["attempted"] > 0
