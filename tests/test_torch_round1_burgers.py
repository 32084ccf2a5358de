"""The Burgers recipes of the port's round-1 validation runner at `--scale
tiny` on the CPU: each prints a SUMMARY with exactly the keys of its JAX
results JSON, and the comparison lines (see tests/test_torch_round1.py);
the InfFT run also its bf16 / float32 check; the 20,000-step recipe
resumes its pretrain from a state directory and stops at a deadline."""
import pytest
import torch

from tests.test_torch_round1 import check_tiny_run
from safediffcon_torch.experiments import round1 as R1
from safediffcon_torch.tasks.burgers import BurgersDataset, BurgersPretrainConfig, pretrain
from safediffcon_torch.utils.checkpoint import latest_step

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["burgers", "burgers_infft", "burgers_20k"])
def test_tiny_run_prints_the_jax_summary(name, tmp_path):
    res, lines = check_tiny_run(name, tmp_path)
    if name == "burgers_infft":
        assert any(x.startswith("DTYPE bf16 vs float32") for x in lines)
        assert set(res["dtype_rel"]) == {"control_mse_mean (J)", "Q"}
        assert [s["pair"] for s in res["signs"]][0] == "bfloat16->infft"
    elif name == "burgers_20k":
        assert [s["pair"] for s in res["signs"]][::5] == ["pretrain20k->posttrain",
                                                          "posttrain->posttrain_infft"]
        # the pretrain state lands under the output directory, not the script's /tmp path
        assert latest_step(str(tmp_path / "b_long_ckpt")) == 4
        assert "PRETRAIN step 4 of 4, state dir " + str(tmp_path / "b_long_ckpt") in lines
    else:
        assert [s["pair"] for s in res["signs"]][0] == "pretrain->posttrain"


def test_burgers_20k_resumes_and_stops_its_pretrain(tmp_path):
    lines = []
    res = R1.run_1d_long(scale="tiny", device="cpu", out=str(tmp_path / "a"),
                         pretrain_seconds=0.0, emit=lines.append)
    assert res["pretrain_step"] == 0 and not any(x.startswith("COMPARE") for x in lines)
    # two steps written by an earlier pretrain into the state directory ...
    tiny = R1.recipe("burgers_20k", "tiny", "cpu")
    state_dir = str(tmp_path / "state")
    train = BurgersDataset.load(str(tmp_path / "a" / "burgers_long.npz"), "train")
    pretrain(BurgersPretrainConfig(**tiny["BurgersPretrainConfig"]), train, num_steps=2,
             checkpoint_dir=state_dir, device="cpu")
    # ... are where the runner goes on from; the deadline stops it there
    lines.clear()
    res = R1.run_1d_long(scale="tiny", device="cpu", out=str(tmp_path / "b"), state_dir=state_dir,
                         pretrain_seconds=0.0, emit=lines.append)
    assert res["pretrain_step"] == 2 and res["state_dir"] == state_dir
    assert f"PRETRAIN stopped short: rerun with --state-dir {state_dir} to continue" in lines


def test_state_dir_options_are_burgers_20k_only():
    with pytest.raises(SystemExit):
        R1.main(["smoke", "--device", "cpu", "--state-dir", "x"])
