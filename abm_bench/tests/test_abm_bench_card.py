"""On the card: a short run of each cell at its own size comes out correct.
Skips without a card (decided in the fixture, never at import)."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run their CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["soma-tissue.long", "tumor-spheroid.jobs",
                                      "soma-tissue.sweep"])
def test_a_short_run_of_the_cell_is_correct(workload, card):
    from abm_bench.harness import cli

    res = cli.run_cell(workload, 20261018, 5.0, False)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
