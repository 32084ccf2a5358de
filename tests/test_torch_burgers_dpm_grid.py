"""`tools/burgers_dpm_grid.py` at the `burgers_dpm_refscale` recipe's tiny
sizes on the CPU: every GRID cell of the five settings is printed (the
unguided arms, JAX's Q-hats, the port's own, the nudged EMA, float32), with
the first sims' view beside the whole split's, the EXCESS lines over DDIM
200, no launch of K1 or K2, and the last line's JSON also written to
`--json`; on the CPU the grid takes one eval key, 5000."""
import json
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import burgers_dpm_grid as G  # noqa: E402

ARMS = ("ddim200", "ddim20", "ddim50", "dpm50", "dpm20")


def test_tiny_grid_prints_every_cell(tmp_path, capsys):
    dest = tmp_path / "grid.json"
    assert G.main(["--device", "cpu", "--out", str(tmp_path), "--json", str(dest)]) == 0
    lines = capsys.readouterr().out.splitlines()
    grid = [x.split() for x in lines if x.startswith("GRID ")]
    assert all(len(g) == 10 for g in grid), grid
    cells = {(g[1], g[2], g[3], g[4]) for g in grid}
    want = set()
    for setting, arms, views in [("a", ARMS, ("4", "2")), ("b", G.GUIDED_ARMS, ("4", "2")),
                                 ("c", G.GUIDED_ARMS, ("4", "2")), ("d", G.NUDGED_ARMS, ("4", "2")),
                                 ("a32", G.FLOAT32_ARMS, ("2",))]:
        want |= {(setting, arm, sims, key) for arm in arms for sims in views
                 for key in ("5000", "mean")}
    assert cells == want and len(grid) == len(want)
    # Q = 0 where unguided, JAX's Q-hats in b, the calibrated ones in c and d
    result = json.loads(lines[-1])
    assert result == json.loads(dest.read_text()) and result["eval_keys"] == [5000]
    q = {(r["setting"], r["arm"]): r["Q"] for r in result["rows"]}
    assert all(q["a", arm] == 0.0 for arm in ARMS)
    assert all(q["b", arm] == result["jax_Q"][arm] for arm in G.GUIDED_ARMS)
    assert all(q["c", arm] == result["own_Q"][arm] for arm in G.GUIDED_ARMS)
    assert q["d", "dpm50"] != result["own_Q"]["dpm50"]  # the nudged EMA, calibrated anew
    excess = {(x.split()[1], x.split()[2], x.split()[3]) for x in lines if x.startswith("EXCESS ")}
    assert ("a", "4", "dpm50") in excess and ("a32", "2", "dpm20") in excess
    assert len(excess) == 4 * 2 + 2 * 2 * 2 + 1 * 2 + 2
    assert not result["failed"] and not result["float32_skipped"]
    assert all(v["K1"] == 0 and not v["K2"] and v["K2_simt"] == 0
               for v in result["launches"].values())
