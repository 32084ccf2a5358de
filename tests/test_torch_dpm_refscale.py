"""`burgers_dpm_refscale` of the port's validation runner
(`safediffcon_torch/experiments/round1.py`, the counterpart of
`experiments/run_1d_dpm_refscale_r4.py`) at `--scale tiny` on the CPU: the
SUMMARY keys of `experiments/validation_1d_dpm_round4.json`, 25 COMPARE
rows (J, R_p, R_s, R_t and Q-hat of each of the five sampler arms), one
FEWSTEP line per few-step arm, each arm's route, no launch of K1 or K2 in
any stage, and no pretrain state written (the EMA stays in memory); run
again on a copy of the data file it generated, it reuses the file and gives
the same results. The
recipe against the script by `ast` is a case of `tests/test_torch_round1.py`."""
import torch

from tests.test_torch_refscale_data import check_reused
from tests.test_torch_round1 import check_tiny_run
from safediffcon_torch.experiments import round1 as R1

torch.set_num_threads(1)


def test_tiny_run_prints_25_rows_and_the_few_step_lines(tmp_path):
    res, lines = check_tiny_run("burgers_dpm_refscale", tmp_path, eval_seeds=2)
    arms = [f"{s}{n}" for s, n in R1.BURGERS_DPM_REFSCALE["variants"]]
    rows = res["comparison"]
    assert len(rows) == 25
    assert [r["phase"] for r in rows][::5] == arms
    assert {r["metric"] for r in rows} == {h[0] for h in R1.HEADLINE["burgers"]} | {"Q-hat"}
    few = [x for x in lines if x.startswith("FEWSTEP ")]
    assert [x.split()[1] for x in few] == [a for a in arms if a != R1.DPM_BASELINE]
    assert set(res["fewstep"]) == set(arms) - {R1.DPM_BASELINE}
    # each few-step difference is the two arms' mean J apart, beside JAX's
    j = {r["phase"]: r["port"] for r in rows if r["metric"] == "control_mse_mean (J)"}
    jax = {r["phase"]: r["jax"] for r in rows if r["metric"] == "control_mse_mean (J)"}
    for arm, d in res["fewstep"].items():
        assert abs(d["port"] - (j[arm] - j[R1.DPM_BASELINE])) < 1e-12
        assert abs(d["jax"] - (jax[arm] - jax[R1.DPM_BASELINE])) < 1e-12
    # the tiny cut keeps five arms of the same samplers at fewer steps
    summary = res["summary"]
    tiny = R1.recipe("burgers_dpm_refscale", "tiny", "cpu")["variants"]
    assert [(summary[a]["sampler"], summary[a]["steps"]) for a in arms] == tiny
    assert [s for s, _ in tiny] == [s for s, _ in R1.BURGERS_DPM_REFSCALE["variants"]]
    # read from each arm's pipeline: on the CPU no call is captured
    none = dict(graphs=0, replays=0)
    assert [x for x in lines if x.startswith("ROUTE ")] == [
        f"ROUTE {a}: calibrate 0 graphs captured, 0 replays, evaluate 0 graphs captured, "
        f"0 replays" for a in arms]
    assert res["routes"] == {a: {"calibrate": none, "evaluate": none} for a in arms}
    # neither TPU-kernel counterpart runs on this path, in any stage
    assert all(v["K1"] == 0 and not v["K2"] and v["K2_simt"] == 0
               for v in res["launches"].values())
    assert set(res["stages"]) == {"datagen", "pretrain"} | {
        f"{a}_{p}" for a in arms for p in ("calibrate", "evaluate")}
    # burgers_refscale's pretrain, without its checkpoints
    assert not [p for p in tmp_path.iterdir() if p.is_dir()]
    assert all(summary[a]["eval_s_steady"] is not None for a in arms)
    # its data file, copied to a fresh directory, is reused to the same results
    check_reused("burgers_dpm_refscale", tmp_path, res, lines, eval_seeds=2)
