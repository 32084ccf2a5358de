"""The reference-scale recipes of the port's validation runner
(`safediffcon_torch/experiments/round1.py`: `tokamak_refscale`,
`burgers_refscale`): their round-2 overrides are what the scripts were when
they wrote `experiments/validation_{tokamak,1d}_refscale_round2.json`, and
each recipe at `--scale tiny` on the CPU prints the SUMMARY keys of its JAX
results JSON, 15 COMPARE rows, the SIGN lines of its two steps, and counts
no launch of K1 or K2 in any stage; run again on a copy of the data file it
generated, it reuses the file and gives the same results. (The recipes
against today's scripts by `ast`, and the tiny and card settings, are cases
of `tests/test_torch_round1.py`.)"""
import json
from pathlib import Path

import pytest
import torch

from tests.test_torch_refscale_data import check_reused
from tests.test_torch_round1 import check_tiny_run
from safediffcon_torch.experiments import round1 as R1
from safediffcon_torch.tasks.tokamak import posttrain_config
from safediffcon_torch.utils.checkpoint import latest_step

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

# experiments/run_tokamak_refscale.py at 3dfca3d, whose run wrote the round-2
# JSON (committed at 14357c1): the pretrain length's default, the checkpoint
# cadence, and the arguments it did not pass yet (fe54396 added the
# fine-tune's finetune_guidance_scaler, a later change resume_dir)
TOKAMAK_3DFCA3D = dict(TOK_PRETRAIN_STEPS=20_000, checkpoint_every=5_000,
                       not_passed=("resume_dir", "finetune_guidance_scaler"))


def test_round2_overrides_are_the_round2_scripts():
    tok = R1.recipe("tokamak_refscale", "full", "cpu")
    assert tok["pretrain"]["num_steps"] == TOKAMAK_3DFCA3D["TOK_PRETRAIN_STEPS"]
    assert tok["TokamakPretrainConfig"]["checkpoint_every"] == TOKAMAK_3DFCA3D["checkpoint_every"]
    assert "resume_dir" not in tok["pretrain"] and "checkpoint_dir" in tok["pretrain"]
    assert "finetune_guidance_scaler" not in tok["replace.conformal"]
    # exactly these, against today's script (the recipe dict)
    changed = {(key, k) for key, kw in R1.ROUND2["tokamak_refscale"].items() for k in kw}
    assert changed == {("pretrain", "num_steps"), ("pretrain", "resume_dir"),
                       ("TokamakPretrainConfig", "checkpoint_every"),
                       ("replace.conformal", "finetune_guidance_scaler")}
    assert {k for key, k in changed if R1.ROUND2["tokamak_refscale"][key][k] is None} == set(
        TOKAMAK_3DFCA3D["not_passed"])
    # the Burgers script with B_PRETRAIN_STEPS at the pretrain_steps its JSON records
    with open(ROOT / R1.JAX_RESULTS["burgers_refscale"]) as f:
        steps = json.load(f)["pretrain_steps"]
    assert R1.ROUND2["burgers_refscale"] == {"pretrain": {"num_steps": steps}} and steps == 50_000
    assert R1.recipe("burgers_refscale", "full", "cpu")["pretrain"]["num_steps"] == 50_000


@pytest.mark.parametrize("name", ["tokamak_refscale", "burgers_refscale"])
def test_tiny_run_prints_the_jax_summary(name, tmp_path):
    res, lines = check_tiny_run(name, tmp_path, eval_seeds=2)
    last = "finetune" if name == "tokamak_refscale" else "infft"
    pairs = ["pretrain->posttrain", f"posttrain->{last}"]
    signs = [x for x in lines if x.startswith("SIGN ")]
    assert [x.split()[1] for x in signs] == [p for p in pairs for _ in range(5)]
    assert [s["pair"] for s in res["signs"]][::5] == pairs
    assert [r["phase"] for r in res["comparison"]][::5] == ["pretrain", "posttrain", last]
    # neither TPU-kernel counterpart runs on these paths
    assert all(v["K1"] == 0 and not v["K2"] and v["K2_simt"] == 0
               for v in res["launches"].values())
    assert {"datagen", "pretrain", "pretrain_calibrate", "posttrain", last} <= set(res["stages"])
    # the pretrain state lands under the output directory, not the script's /tmp path
    ckpt = "tok_ref_ckpt" if name == "tokamak_refscale" else "b_ref_ckpt"
    assert latest_step(str(tmp_path / ckpt)) == 4
    if name == "tokamak_refscale":
        # the backward fine-tune's composite weight: the posttrain Q-hat, the
        # posttrain config's w_obj / w_safe, round 2's guidance scaler of 1.0
        conf, pt = res["finetune_conformal"], posttrain_config().conformal
        assert conf["finetune_quantile"] == res["summary"]["Q_posttrain"]
        assert (conf["finetune_w_obj"], conf["finetune_w_safe"]) == (pt.w_obj, pt.w_safe)
        assert conf["finetune_guidance_scaler"] == 1.0 and pt.guidance_scaler == 5.0
        assert conf["finetune_set"] == "test" and not conf["wo_post_train"]
        assert [h["epoch"] for h in res["summary"]["finetune_history"]] == [0, 1]
    else:
        assert res["summary"]["pretrain_steps"] == 4
    # its data file, copied to a fresh directory, is reused to the same results
    check_reused(name, tmp_path, res, lines, eval_seeds=2)
