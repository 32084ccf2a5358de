"""The Burgers recipes of the port's round-1 validation runner at `--scale
tiny` on the CPU: each prints a SUMMARY with exactly the keys of its JAX
results JSON, and the comparison lines (see tests/test_torch_round1.py);
the InfFT run also its bf16 / float32 check."""
import pytest
import torch

from tests.test_torch_round1 import check_tiny_run

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["burgers", "burgers_infft"])
def test_tiny_run_prints_the_jax_summary(name, tmp_path):
    res, lines = check_tiny_run(name, tmp_path)
    if name == "burgers_infft":
        assert any(x.startswith("DTYPE bf16 vs float32") for x in lines)
        assert set(res["dtype_rel"]) == {"control_mse_mean (J)", "Q"}
        assert [s["pair"] for s in res["signs"]][0] == "bfloat16->infft"
    else:
        assert [s["pair"] for s in res["signs"]][0] == "pretrain->posttrain"
