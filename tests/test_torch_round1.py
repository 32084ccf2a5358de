"""The port's round-1 validation runner (`safediffcon_torch/experiments/
round1.py`) against the JAX package's scripts: (a) the keyword arguments of
every config constructor, `generate_*_dataset`, `pretrain`, pipeline and
fine-tuning call of each `experiments/run_*_validation.py`, parsed with
`ast`, equal the port's recipe dicts; (b) each recipe at `--scale tiny` on
the CPU prints a SUMMARY with exactly the keys of its JAX results JSON (at
every depth), then one COMPARE line per headline metric and phase; (c) the
band and the in / out verdict on fixed numbers."""
import ast
import copy
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from safediffcon_torch.experiments import round1 as R1
from safediffcon_torch.models.convert import load_flax_npz, load_flax_params
from safediffcon_torch.tasks.smoke.pipeline import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_FINETUNE_CALLS = {"pretrain", "posttrain", "run_inference", "inference_finetune"}


def _callee(func) -> str:
    """`P.pretrain` -> "pretrain"; a dataset's `BurgersDataset.load` keeps
    its class' name."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        if func.attr == "load" and isinstance(func.value, ast.Name):
            return f"{func.value.id}.load"
        return func.attr
    return ""


def _of_interest(name: str) -> bool:
    return (name.endswith(("Config", "Pipeline", "_config")) or name in _FINETUNE_CALLS
            or (name.startswith("generate_") and name.endswith("_dataset"))
            or name.endswith("Dataset.load") or name == "replace")


def _constants(tree) -> dict:
    """Module-level names bound to a literal, or to an environment
    variable's default (`int(os.environ.get("X", 200_000))`)."""
    out = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
                and value.func.id == "int" and len(value.args) == 1
                and isinstance(value.args[0], ast.Call)
                and ast.unparse(value.args[0].func) == "os.environ.get"):
            value = value.args[0].args[1]
        literal = _literal(value)
        if literal is not None:
            out[node.targets[0].id] = literal
    return out


def _literal(node):
    """The value of a keyword argument made of constants (10**9 included),
    or None where it names a variable or calls something."""
    for sub in ast.walk(node):
        if not isinstance(sub, (ast.Constant, ast.Tuple, ast.List, ast.BinOp, ast.UnaryOp,
                                ast.operator, ast.unaryop, ast.Load)):
            return None
    return eval(compile(ast.Expression(node), "<kwarg>", "eval"), {"__builtins__": {}})


def _kwarg(node, constants: dict, in_replace: bool, loop_names=frozenset()):
    """A keyword argument's value: a literal, a module constant's value, or,
    in a `dataclasses.replace` or for a `for` loop's variable, the source
    text of what the script computes there; None for anything else (a call
    of interest is recorded on its own)."""
    literal = _literal(node)
    if literal is not None:
        return literal
    if isinstance(node, ast.Name) and node.id in constants:
        return constants[node.id]
    if isinstance(node, ast.Name) and node.id in loop_names:
        return node.id
    if in_replace and not (isinstance(node, ast.Call) and _of_interest(_callee(node.func))):
        return ast.unparse(node)
    return None


def script_calls(path: Path) -> dict:
    """{callee: literal keyword arguments} of the calls of interest of a
    script, a list in source order where one callee takes two argument
    sets; a call that is another's keyword argument is "Outer.keyword". A
    config factory (`posttrain_config()`) counts without arguments too; a
    name bound at module level to a constant (or an environment variable's
    default) stands for its value, and a `for` loop's variable for its
    name. A module constant a `for` loop runs over (`for v in NAME`, `for s
    in range(NAME)`) is recorded under its name."""
    tree = ast.parse(path.read_text())
    constants = _constants(tree)
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)]
    loop_names = {sub.id for n in loops for sub in ast.walk(n.target) if isinstance(sub, ast.Name)}
    nested = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if isinstance(kw.value, ast.Call):
                    nested[id(kw.value)] = f"{_callee(node.func)}.{kw.arg}"
    found = {}
    for n in loops:
        it = n.iter
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name) and it.func.id == "range"
                and len(it.args) == 1):
            it = it.args[0]
        if isinstance(it, ast.Name) and it.id in constants:
            found[it.id] = [constants[it.id]]
    calls = sorted((n for n in ast.walk(tree) if isinstance(n, ast.Call)),
                   key=lambda n: (n.lineno, n.col_offset))
    for node in calls:
        name = _callee(node.func)
        if not _of_interest(name):
            continue
        kwargs = {kw.arg: _kwarg(kw.value, constants, name == "replace", loop_names)
                  for kw in node.keywords}
        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        if not kwargs and not name.endswith("_config"):
            continue
        key = nested.get(id(node), name)
        sets = found.setdefault(key, [])
        if kwargs not in sets:
            sets.append(kwargs)
    return {k: v[0] if len(v) == 1 else v for k, v in found.items()}


@pytest.mark.parametrize("name", sorted(R1.RECIPES))
def test_recipes_equal_the_scripts(name):
    assert R1.RECIPES[name] == script_calls(ROOT / R1.SCRIPTS[name])


def test_dtype_check_equals_the_script():
    tree = ast.parse((ROOT / R1.SCRIPTS["burgers_infft"]).read_text())
    loops = [n for n in ast.walk(tree) if isinstance(n, ast.For)
             and isinstance(n.target, ast.Name) and n.target.id == "dt"]
    assert len(loops) == 1 and ast.literal_eval(loops[0].iter) == R1.DTYPE_CHECK


def test_dpm_calls_equal_the_script():
    """run_1d_dpm_refscale_r4.py: calibrate at Q = 0 with PRNGKey(0), evaluate
    with PRNGKey(5000 + s) for s < N_SEEDS, one pipeline per variant; its
    datagen is burgers_refscale's."""
    tree = ast.parse((ROOT / R1.SCRIPTS["burgers_dpm_refscale"]).read_text())
    calls = {ast.unparse(n.func).split(".")[-1]: n for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr in ("calibrate", "evaluate")}
    cal, ev = calls["calibrate"], calls["evaluate"]
    assert ast.literal_eval(cal.args[2]) == R1.DPM_CALIBRATE_Q
    assert ast.unparse(cal.args[3]) == "rng"
    keys = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
            and ast.unparse(n.targets[0]) == "rng"]
    assert [ast.unparse(n.value) for n in keys] == [
        f"jax.random.PRNGKey({R1.DPM_CALIBRATE_KEY})"]
    assert ast.unparse(ev.args[3]) == f"jax.random.PRNGKey({R1.DPM_EVAL_KEY_BASE} + s)"
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For)
                and ast.unparse(n.target) == "s")
    assert ast.unparse(loop.iter) == "range(N_SEEDS)"
    assert R1.RECIPES["burgers_dpm_refscale"]["N_SEEDS"] == 3  # the runner's --eval-seeds default
    assert (R1.RECIPES["burgers_dpm_refscale"]["generate_burgers_dataset"]
            == R1.RECIPES["burgers_refscale"]["generate_burgers_dataset"])
    with open(ROOT / R1.JAX_RESULTS["burgers_dpm_refscale"]) as f:
        arms = json.load(f)
    assert sorted(arms) == sorted(f"{s}{n}" for s, n in R1.BURGERS_DPM_REFSCALE["variants"])
    assert R1.DPM_BASELINE in arms


def test_tiny_and_card_settings_change_no_recipe_key():
    for name in R1.RECIPES:
        assert set(R1.TINY[name]) <= set(R1.RECIPES[name])
        assert set(R1.CARD[name]) <= set(R1.RECIPES[name])
        round2 = R1.ROUND2.get(name, {})
        assert set(round2) <= set(R1.RECIPES[name])
        want = copy.deepcopy(R1.RECIPES[name])
        for key, kw in round2.items():  # the round-2 overrides; an argument at None is dropped
            want[key] = {k: v for k, v in {**want[key], **kw}.items() if v is not None}
        assert R1.recipe(name, "full", "cpu") == want
    for name in ("smoke", "smoke_posttrain"):
        assert R1.recipe(name, "full", "cuda")["SmokePretrainConfig"]["conv_impl"] == "pallas"
    # a list of tiny cuts goes entry by entry: the backward fine-tune keeps its one step
    tiny = R1.recipe("smoke_posttrain", "tiny", "cpu")["SmokeInferenceConfig"]
    assert [d["finetune_steps"] for d in tiny] == [2, 1] and tiny[1]["backward_finetune"]
    tiny = R1.recipe("burgers_infft", "tiny", "cuda")["BurgersPipeline"]
    assert [d["dim"] for d in tiny] == [8, 8] and tiny[1]["compute_dtype"] == "bfloat16"


def _keys(x):
    """The key structure of a JSON value: dicts by key, lists by their
    first element."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return None


@pytest.mark.parametrize("name", ["tokamak", "smoke", "smoke_posttrain"])
def test_tiny_run_prints_the_jax_summary(name, tmp_path):
    res, lines = check_tiny_run(name, tmp_path)
    if name == "smoke":  # the evaluated EMA weights, as a flax tree for the JAX package
        tree = load_flax_npz(str(tmp_path / "smoke_ema_flax.npz"))
        load_flax_params(build_model(8, (1, 2), device="cpu"), tree)  # strict: every tensor
    if name.startswith("smoke"):
        phases = {r["phase"] for r in res["comparison"]}
        assert sorted(x.split()[1] for x in lines if x.startswith("CONTROL ")) == sorted(phases)
    if name == "smoke_posttrain":
        assert [s["pair"] for s in res["signs"]][0] == "posttrain0->posttrain1"
        assert [h["epoch"] for h in res["summary"]["posttrain_history"]] == [0, 1]
        assert [h["epoch"] for h in res["summary"]["backward_history"]] == [0]
        # each extra evaluation is a stage of its own, outside its fine-tuning stage
        assert {"posttrain", "posttrain0_evaluate", "posttrain1_evaluate", "backward",
                "backward0_evaluate"} <= set(res["stages"])


def check_tiny_run(name, tmp_path, eval_seeds=2):
    lines = []
    res = R1.RUNS[name](scale="tiny", eval_seeds=eval_seeds, device="cpu", out=str(tmp_path),
                        emit=lines.append)
    summary = json.loads(next(x for x in lines if x.startswith("SUMMARY "))[8:])
    with open(ROOT / R1.JAX_RESULTS[name]) as f:
        assert _keys(summary) == _keys(json.load(f))
    assert summary == res["summary"]
    headline = R1.HEADLINE[name]
    compares = [x for x in lines if x.startswith("COMPARE ")]
    n_phases = {"burgers": 2, "burgers_infft": 3, "tokamak": 2, "smoke": 1, "smoke_posttrain": 3,
                "burgers_20k": 3, "tokamak_refscale": 3, "burgers_refscale": 3,
                "burgers_dpm_refscale": 5}[name]
    assert len(compares) == n_phases * (len(headline) + 1)
    for row in res["comparison"]:
        assert row["result"] in ("in", "out") and math.isfinite(row["band"])
        assert row["seeds"] == (1 if row["metric"] == "Q-hat" else eval_seeds)
    assert all(np.isfinite(v) for v in res["stages"].values())
    saved = json.loads((tmp_path / f"round1_{name}.json").read_text())
    assert saved["summary"] == json.loads(json.dumps(summary))
    return res, lines


# ---------------------------------------------------------------------------
# (c) bands and verdicts on fixed numbers
# ---------------------------------------------------------------------------

def test_band_of_a_mean():
    # per-sample term dominates: 3 * 0.5 / sqrt(25) = 0.3
    assert R1.band("mean", [1.0, 1.0, 1.0], 25, per_sample_std=0.5) == pytest.approx(0.3)
    # across-seed term dominates: std([1, 2, 3]) = 1 -> 3
    assert R1.band("mean", [1.0, 2.0, 3.0], 25, per_sample_std=0.5) == pytest.approx(3.0)
    # one seed: no across-seed term
    assert R1.band("mean", [7.0], 4, per_sample_std=2.0) == pytest.approx(3.0)


def test_band_of_a_ratio():
    # p = 0.2, n = 100: 3 * sqrt(0.16 / 100) = 0.12
    assert R1.band("ratio", [0.2, 0.2], 100) == pytest.approx(0.12)
    assert R1.band("percent", [20.0, 20.0], 100) == pytest.approx(12.0)
    # p = 1 or 0 leaves only the across-seed term
    assert R1.band("ratio", [1.0, 1.0, 1.0], 50) == 0.0
    assert R1.band("ratio", [0.9, 1.0, 1.1], 50) == pytest.approx(0.3)
    with pytest.raises(ValueError):
        R1.band("median", [1.0], 3)


def test_verdict_and_signs():
    assert R1.verdict(1.0, 1.2, 0.2) == "in"
    assert R1.verdict(1.0, 1.2000001, 0.2) == "out"
    assert R1.verdict(0.5, 0.5, 0.0) == "in"
    before = R1.Phase("pre", [{"m": 1.0}, {"m": 3.0}], 5.0, 0.1, {"m": 2.0}, 4.0)
    after = R1.Phase("post", [{"m": 1.0}, {"m": 1.0}], 4.0, 0.1, {"m": 2.5}, 4.0)
    got = R1.signs(before, after, [("m", "mean", None)])
    assert got == [dict(metric="m", port="-", jax="+", agree=False),
                   dict(metric="Q-hat", port="-", jax="0", agree=False)]


def test_compare_rows():
    ph = R1.Phase("pretrain", [{"J": 0.4, "J_std": 0.5, "R": 0.2},
                               {"J": 0.6, "J_std": 0.3, "R": 0.2}], 40.0, 2.0,
                  {"J": 0.45, "R": 0.5}, 47.0)
    rows = R1.compare([ph], [("J", "mean", "J_std"), ("R", "ratio", None)], 25)
    j, r, q = rows
    # J: across std(0.4, 0.6) = 0.1414 > 0.4 / 5 = 0.08 -> band 0.424
    assert j["port"] == pytest.approx(0.5) and j["band"] == pytest.approx(3 * 0.1414214, 1e-5)
    assert j["result"] == "in"
    # R: 3 * sqrt(0.2 * 0.8 / 25) = 0.24 < 0.3 away
    assert r["band"] == pytest.approx(0.24) and r["result"] == "out"
    assert q == dict(phase="pretrain", metric="Q-hat", port=40.0, port_std=0.0, seeds=1,
                     jax=47.0, band=6.0, result="out")


def test_a_stage_inside_another_counts_only_there(tmp_path, monkeypatch):
    counts = {"K1": 0, "K2": {"bf16": 0}, "K2_simt": 0}
    monkeypatch.setattr(R1, "kernel_counts", lambda: copy.deepcopy(counts))
    run = R1.Run("smoke", "cpu", "tiny", None, 1, str(tmp_path), emit=lambda line: None)
    with run.stage("outer"):
        counts["K1"] += 1
        time.sleep(0.05)
        with run.stage("inner"):
            counts["K1"] += 10
            counts["K2"]["bf16"] += 3
            time.sleep(0.2)
        counts["K1"] += 100
    with run.stage("outer"):  # a second entry adds to the first
        counts["K1"] += 1000
    assert run.launches["outer"] == {"K1": 1101, "K2": {}, "K2_simt": 0}
    assert run.launches["inner"] == {"K1": 10, "K2": {"bf16": 3}, "K2_simt": 0}
    assert 0.2 <= run.stages["inner"] and 0.05 <= run.stages["outer"] < 0.2


def test_bootstrap_of_the_quantile():
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.normal(size=400).astype(np.float32))
    weights = torch.ones(400)
    std = R1.bootstrap_q_std(scores, weights, 0.9, "alpha")
    # the 0.9 quantile of N(0, 1) has std sqrt(0.09) / (phi(1.2816) sqrt(n)) = 0.086
    assert 0.05 < std < 0.13
    assert R1.bootstrap_q_std(scores, weights, 0.9, "alpha") == std  # seeded
    assert R1.bootstrap_q_std(torch.ones(50), torch.ones(50), 0.9, "alpha") == 0.0
