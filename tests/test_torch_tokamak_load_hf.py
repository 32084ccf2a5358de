"""`TokamakDataset.load_hf` of the port against the JAX package's, on
datasets written by `datasets.Dataset.save_to_disk` (one shard, several
shards of several record batches, float32 and float64 columns, and the
reference's consolidation step through `tools/consolidate_tokamak.py`):
every split and `subset` equal bit for bit. The port's reader
(`utils/arrow_ipc.py`) imports neither `datasets` nor `pyarrow`; layouts it
does not decode raise."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from safediffcon_tpu.tasks.tokamak.data import TokamakDataset as JTokamak
from safediffcon_torch.cli import main as M
from safediffcon_torch.tasks.tokamak.data import TokamakDataset
from safediffcon_torch.utils import arrow_ipc

datasets = pytest.importorskip("datasets")
pa = pytest.importorskip("pyarrow")

ROOT = Path(__file__).resolve().parents[1]
SPLITS = dict(n_train=5, n_cal=2, n_test=1)


def _write(path, outputs, actions, **kw):
    datasets.Dataset.from_dict({"outputs": list(outputs), "actions": list(actions)}
                               ).save_to_disk(str(path), **kw)
    return str(path)


def _assert_equal(path, split, **kw):
    got = TokamakDataset.load_hf(path, split, **kw)
    ref = JTokamak.load_hf(path, split, **kw)
    for name in ("data", "state_phys"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    return got


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_load_hf_equals_jax(tmp_path, dtype, num_shards):
    rng = np.random.default_rng(num_shards)
    outputs = rng.normal(size=(8, 122, 8)).astype(dtype)
    actions = rng.normal(size=(8, 121, 9)).astype(dtype)
    path = _write(tmp_path / "ds", outputs, actions, num_shards=num_shards)
    for split, n in (("train", 5), ("cal", 2), ("test", 1)):
        assert len(_assert_equal(path, split, **SPLITS)) == n
    for subset in (1, 3, 9):
        assert len(_assert_equal(path, "train", subset=subset, **SPLITS)) == min(subset, 5)
    _assert_equal(path, "cal", subset=1, **SPLITS)


def test_load_hf_several_record_batches(tmp_path):
    """2,100 rows in 2 shards: each shard's stream holds two record batches
    (datasets writes 1,000 rows per batch)."""
    rng = np.random.default_rng(7)
    outputs = rng.normal(size=(2100, 122, 8)).astype(np.float32)
    actions = rng.normal(size=(2100, 121, 9))
    path = _write(tmp_path / "ds", outputs, actions, num_shards=2)
    stream = sorted((tmp_path / "ds").glob("*.arrow"))[0].read_bytes()
    assert len(list(pa.ipc.open_stream(stream))) == 2
    kw = dict(n_train=2000, n_cal=60, n_test=40)
    for split in ("train", "cal", "test"):
        _assert_equal(path, split, **kw)
    _assert_equal(path, "cal", subset=25, **kw)


def test_load_hf_after_consolidation(tmp_path):
    """The reference's data preparation: per-seed `{i}.npz` rollout dicts ->
    `tools/consolidate_tokamak.py` -> save_to_disk -> load_hf (four columns,
    two of them unused)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from consolidate_tokamak import consolidate_dataset

    rng = np.random.default_rng(3)
    seeds = tmp_path / "seeds"
    seeds.mkdir()
    for i in range(6):
        np.savez(seeds / f"{i}.npz", data={
            "inputs": rng.normal(size=(122, 18)).astype(np.float32),
            "outputs": rng.normal(size=(122, 8)).astype(np.float32),
            "actions": rng.normal(size=(121, 9)).astype(np.float32),
            "targets": rng.normal(size=(3,)).astype(np.float32),
        })
    out = tmp_path / "consolidated_dataset"
    consolidate_dataset(str(seeds), 0, 6).save_to_disk(str(out))
    kw = dict(n_train=4, n_cal=1, n_test=1)
    for split in ("train", "cal", "test"):
        _assert_equal(str(out), split, **kw)
    assert sorted(arrow_ipc.load_from_disk(str(out))) == ["actions", "inputs", "outputs",
                                                          "targets"]


def test_load_hf_errors_as_jax(tmp_path):
    rng = np.random.default_rng(5)
    path = _write(tmp_path / "ds", rng.normal(size=(8, 122, 8)), rng.normal(size=(8, 121, 9)))
    for loader in (TokamakDataset.load_hf, JTokamak.load_hf):
        with pytest.raises(ValueError, match="split must be one of"):
            loader(path, "validation", **SPLITS)
        with pytest.raises(IndexError):  # a range past the last row
            loader(path, "test", n_train=5, n_cal=2, n_test=4)


def test_dispatch_load_reads_the_directory(tmp_path):
    rng = np.random.default_rng(6)
    path = _write(tmp_path / "ds", rng.normal(size=(8, 122, 8)), rng.normal(size=(8, 121, 9)),
                  num_shards=2)
    got = M._dispatch_load(TokamakDataset, path, "cal", **SPLITS)
    ref = JTokamak.load_hf(path, "cal", **SPLITS)
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.state_phys, ref.state_phys)


def _stream_dir(tmp_path, table, **options):
    """A save_to_disk-shaped directory around one stream pyarrow writes."""
    d = tmp_path / "odd"
    d.mkdir()
    sink = pa.BufferOutputStream()
    opts = pa.ipc.IpcWriteOptions(**options)
    with pa.ipc.new_stream(sink, table.schema, options=opts) as w:
        w.write_table(table)
    (d / "data-00000-of-00001.arrow").write_bytes(sink.getvalue().to_pybytes())
    (d / "state.json").write_text(json.dumps(
        {"_data_files": [{"filename": "data-00000-of-00001.arrow"}]}))
    return str(d)


UNKNOWN = {
    "string column": lambda: pa.table({"a": pa.array(["x", "y"])}),
    "ragged lists": lambda: pa.table({"a": pa.array([[1.0, 2.0], [3.0]])}),
    "null entry": lambda: pa.table({"a": pa.array([[1.0, None], [3.0, 4.0]])}),
    "null row": lambda: pa.table({"a": pa.array([[1.0, 2.0], None])}),
    "dictionary": lambda: pa.table({"a": pa.array(["x", "y", "x"]).dictionary_encode()}),
    "bool values": lambda: pa.table({"a": pa.array([[True], [False]])}),
    "fixed-size list": lambda: pa.table({"a": pa.array([[1.0, 2.0]],
                                                       pa.list_(pa.float32(), 2))}),
}


@pytest.mark.parametrize("case", sorted(UNKNOWN))
def test_reader_raises_on_unknown_layouts(tmp_path, case):
    path = _stream_dir(tmp_path, UNKNOWN[case]())
    with pytest.raises(arrow_ipc.ArrowFormatError):
        arrow_ipc.load_from_disk(path)


def test_reader_raises_on_compressed_bodies(tmp_path):
    codec = next((c for c in ("zstd", "lz4") if pa.Codec.is_available(c)), None)
    if codec is None:
        pytest.skip("this pyarrow has no IPC compression codec")
    table = pa.table({"a": pa.array([[1.0, 2.0], [3.0, 4.0]])})
    path = _stream_dir(tmp_path, table, compression=codec)
    with pytest.raises(arrow_ipc.ArrowFormatError, match="compressed"):
        arrow_ipc.load_from_disk(path)


def test_reader_raises_on_files_that_are_not_streams(tmp_path):
    table = pa.table({"a": pa.array([[1.0, 2.0], [3.0, 4.0]])})
    path = Path(_stream_dir(tmp_path, table))
    data = path / "data-00000-of-00001.arrow"
    full = data.read_bytes()
    data.write_bytes(full[:-8])  # no end-of-stream marker
    with pytest.raises(arrow_ipc.ArrowFormatError, match="end-of-stream"):
        arrow_ipc.load_from_disk(str(path))
    with pa.OSFile(str(data), "wb") as f, pa.ipc.new_file(f, table.schema) as w:
        w.write_table(table)  # the IPC *file* format starts with "ARROW1"
    with pytest.raises(arrow_ipc.ArrowFormatError, match="continuation"):
        arrow_ipc.load_from_disk(str(path))
    (path / "state.json").write_text(json.dumps({"_data_files": []}))
    with pytest.raises(arrow_ipc.ArrowFormatError, match="no data files"):
        arrow_ipc.load_from_disk(str(path))


def test_reader_decodes_large_lists_and_integers(tmp_path):
    rng = np.random.default_rng(8)
    a = rng.normal(size=(1200, 3, 4)).astype(np.float32)
    b = rng.integers(-100, 100, size=(1200, 5)).astype(np.int16)
    c = rng.integers(0, 2**40, size=(1200, 2)).astype(np.uint64)
    feats = datasets.Features({
        "a": datasets.LargeList(datasets.LargeList(datasets.Value("float32"))),
        "b": datasets.List(datasets.Value("int16")),
        "c": datasets.List(datasets.Value("uint64")),
    })
    datasets.Dataset.from_dict({"a": a, "b": b, "c": c}, features=feats).save_to_disk(
        str(tmp_path / "ds"), num_shards=2)
    cols = arrow_ipc.load_from_disk(str(tmp_path / "ds"))
    for name, ref in (("a", a), ("b", b), ("c", c)):
        assert cols[name].dtype == ref.dtype
        np.testing.assert_array_equal(cols[name], ref)
    assert list(arrow_ipc.load_from_disk(str(tmp_path / "ds"), ["b"])) == ["b"]
