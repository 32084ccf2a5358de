"""The three reference-scale recipes of the port's validation runner
(`safediffcon_torch/experiments/round1.py`: `tokamak_refscale`,
`burgers_refscale`, `burgers_dpm_refscale`) generate their data file only
when it is missing, as their scripts do (`experiments/run_tokamak_refscale.py`,
`run_1d_refscale.py`, `run_1d_dpm_refscale_r4.py`). `check_reused` runs a
recipe again in a fresh directory holding only a copy of the data file that
a tiny run generated: it prints `DATA reused` with the same digest, leaves
the file as it was, and gives the same results (called by the tiny-run tests
of `tests/test_torch_refscale.py` and `tests/test_torch_dpm_refscale.py`).
Here: a data file of other sizes (a tiny run's, in a full-scale run's
directory) is refused before any work."""
import shutil

import numpy as np
import pytest
import torch

from safediffcon_torch.experiments import round1 as R1

torch.set_num_threads(1)

DATA = {"tokamak_refscale": "tok_ref.npz", "burgers_refscale": "burgers_ref.npz",
        "burgers_dpm_refscale": "burgers_ref.npz"}
TAILS = {"tok_ref.npz": dict(states=(122, 3), actions=(121, 9)),
         "burgers_ref.npz": dict(u=(11, 128), f=(10, 128))}


def _no_times(tree):
    """`tree` without its wall-clock entries (keys ending in `_s`, `_s_first`,
    `_s_steady`)."""
    if isinstance(tree, dict):
        return {k: _no_times(v) for k, v in tree.items()
                if not k.endswith(("_s", "_s_first", "_s_steady"))}
    if isinstance(tree, list):
        return [_no_times(v) for v in tree]
    return tree


def _data_line(lines, path):
    data = [x.split() for x in lines if x.startswith("DATA ")]
    assert len(data) == 1 and data[0][2] == str(path), data
    return data[0]


def check_reused(name, first, res, lines, eval_seeds):
    """The tiny run of `name` in directory `first` (its result `res`, its
    printed `lines`) generated its data file; a second run in a directory
    holding only a copy of that file reuses it and gives the same results."""
    line = _data_line(lines, first / DATA[name])
    assert line[1] == "generated" and len(line[3]) == 64
    again = first.parent / f"{first.name}_again"
    again.mkdir()
    shutil.copy(first / DATA[name], again / DATA[name])
    stamp = (again / DATA[name]).stat().st_mtime_ns
    lines2 = []
    res2 = R1.RUNS[name](scale="tiny", eval_seeds=eval_seeds, device="cpu", out=str(again),
                         emit=lines2.append)
    line2 = _data_line(lines2, again / DATA[name])
    assert line2[1] == "reused" and line2[3] == line[3]
    assert (again / DATA[name]).stat().st_mtime_ns == stamp  # read, not written again
    assert _no_times(res2["summary"]) == _no_times(res["summary"])
    assert res2["comparison"] == res["comparison"]
    assert "datagen" in res2["stages"]


@pytest.mark.parametrize("name", sorted(DATA))
def test_data_file_of_other_sizes_is_refused(name, tmp_path):
    """A tiny run's data file (the tiny recipe's split sizes) in a full-scale
    run's directory raises at the datagen stage, before any training."""
    kw = R1.recipe(name, "tiny", "cpu")[
        "generate_tokamak_dataset" if name == "tokamak_refscale" else "generate_burgers_dataset"]
    shapes = R1.split_shapes(kw, **TAILS[DATA[name]])
    np.savez_compressed(tmp_path / DATA[name],
                        **{k: np.zeros(s, np.float32) for k, s in shapes.items()})
    lines = []
    with pytest.raises(ValueError, match="another scale or with other sizes"):
        R1.RUNS[name](scale="full", eval_seeds=1, device="cpu", out=str(tmp_path),
                      emit=lines.append)
    assert not [x for x in lines if x.startswith("DATA ")]
    assert sorted(p.name for p in tmp_path.iterdir()) == [DATA[name]]
