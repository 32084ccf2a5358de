"""A numpy reader of the on-disk layout `datasets.Dataset.save_to_disk`
writes, for the columns of fixed-shape numeric lists the tokamak dataset
holds. It imports neither `datasets` nor `pyarrow`.

The layout: a directory with `state.json`, whose `_data_files` name the
shards in order, and one Arrow IPC *stream* per shard
(`data-0000i-of-0000n.arrow`). A stream is a sequence of messages, each
`0xFFFFFFFF`, an int32 metadata length, a flatbuffer `Message` (padded to 8
bytes) and a body of `bodyLength` bytes; `0xFFFFFFFF 0x00000000` ends it.
The first message is the `Schema`, every other one a `RecordBatch` whose
field nodes and buffers follow the schema's fields depth first (Arrow
columnar format, https://arrow.apache.org/docs/format/Columnar.html).

Decoded: `list` (int32 offsets) and `large_list` (int64 offsets), nested to
any depth, over little-endian float16 / float32 / float64 and integer
values, with or without a validity bitmap, across record batches and
shards. A column decodes to one ndarray of shape (rows, *inner) when every
list at a level has the same length. Anything else raises
`ArrowFormatError`: compressed bodies, dictionary batches or
dictionary-encoded fields, null entries, ragged lists, big-endian data and
other types. Nothing is guessed.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# flatbuffer union tags (Message.fbs MessageHeader, Schema.fbs Type)
_HEADER_SCHEMA, _HEADER_DICTIONARY, _HEADER_RECORD_BATCH = 1, 2, 3
_TYPE_INT, _TYPE_FLOAT, _TYPE_LIST, _TYPE_LARGE_LIST = 2, 3, 12, 21
_FLOAT_DTYPES = {0: "<f2", 1: "<f4", 2: "<f8"}
_CONTINUATION = 0xFFFFFFFF
_MIN_METADATA_VERSION = 3  # V4; V5 (4) is what pyarrow writes


class ArrowFormatError(ValueError):
    """A layout, type or message the reader does not decode."""


class _Table:
    """A flatbuffer table: `pos` is its start in `buf`; fields are looked up
    through its vtable by field id."""

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vtable)[0]

    def _offset(self, field: int) -> int:
        slot = 4 + 2 * field
        if slot >= self.vt_size:
            return 0
        return struct.unpack_from("<H", self.buf, self.vtable + slot)[0]

    def has(self, field: int) -> bool:
        return self._offset(field) != 0

    def scalar(self, field: int, fmt: str, default=0):
        off = self._offset(field)
        return default if off == 0 else struct.unpack_from(fmt, self.buf, self.pos + off)[0]

    def _target(self, field: int) -> Optional[int]:
        off = self._offset(field)
        if off == 0:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, field: int) -> Optional["_Table"]:
        at = self._target(field)
        return None if at is None else _Table(self.buf, at)

    def string(self, field: int) -> Optional[str]:
        at = self._target(field)
        if at is None:
            return None
        n = struct.unpack_from("<I", self.buf, at)[0]
        return self.buf[at + 4 : at + 4 + n].decode("utf-8")

    def tables(self, field: int) -> List["_Table"]:
        at = self._target(field)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for i in range(n):
            el = at + 4 + 4 * i
            out.append(_Table(self.buf, el + struct.unpack_from("<I", self.buf, el)[0]))
        return out

    def structs(self, field: int, fmt: str) -> List[tuple]:
        at = self._target(field)
        if at is None:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        size = struct.calcsize(fmt)
        return [struct.unpack_from(fmt, self.buf, at + 4 + size * i) for i in range(n)]


def _root(buf: bytes) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


class _Field:
    """A schema field: its name, how its values decode, and its children."""

    def __init__(self, t: _Table):
        self.name = t.string(0) or ""
        if t.has(4):
            raise ArrowFormatError(f"field {self.name!r} is dictionary-encoded")
        self.type_id = t.scalar(2, "<B")
        ty = t.table(3)
        self.children = [_Field(c) for c in t.tables(5)]
        if self.type_id == _TYPE_FLOAT:
            precision = ty.scalar(0, "<h")
            if precision not in _FLOAT_DTYPES:
                raise ArrowFormatError(f"field {self.name!r}: float precision {precision}")
            self.dtype = np.dtype(_FLOAT_DTYPES[precision])
        elif self.type_id == _TYPE_INT:
            bits, signed = ty.scalar(0, "<i"), bool(ty.scalar(1, "<B"))
            if bits not in (8, 16, 32, 64):
                raise ArrowFormatError(f"field {self.name!r}: {bits}-bit integers")
            self.dtype = np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
        elif self.type_id in (_TYPE_LIST, _TYPE_LARGE_LIST):
            if len(self.children) != 1:
                raise ArrowFormatError(f"list field {self.name!r} has "
                                       f"{len(self.children)} children")
            self.dtype = np.dtype("<i4" if self.type_id == _TYPE_LIST else "<i8")
        else:
            raise ArrowFormatError(f"field {self.name!r}: Arrow type id {self.type_id} "
                                   f"is not decoded (only lists of numbers)")
        if self.type_id in (_TYPE_INT, _TYPE_FLOAT) and self.children:
            raise ArrowFormatError(f"primitive field {self.name!r} has children")

    def signature(self) -> tuple:
        return (self.name, self.type_id, self.dtype.str,
                tuple(c.signature() for c in self.children))


def _decode(field: _Field, nodes, buffers, body: memoryview) -> np.ndarray:
    """The array of `field` in one record batch, consuming its field nodes
    and buffers (validity, then offsets or values) depth first."""
    length, nulls = next(nodes)
    if nulls:
        raise ArrowFormatError(f"field {field.name!r} has {nulls} null entries")
    next(buffers)  # the validity bitmap: all set when there are no nulls

    def view(count: int) -> np.ndarray:
        offset, size = next(buffers)
        if offset < 0 or offset + size > len(body) or size < count * field.dtype.itemsize:
            raise ArrowFormatError(f"field {field.name!r}: buffer [{offset}, "
                                   f"{offset + size}) does not hold {count} values")
        return np.frombuffer(body, field.dtype, count, offset)

    if field.type_id in (_TYPE_INT, _TYPE_FLOAT):
        return view(length)
    offsets = view(length + 1)
    child = _decode(field.children[0], nodes, buffers, body)
    widths = np.diff(offsets)
    width = int(widths[0]) if length else 0
    if (widths != width).any():
        raise ArrowFormatError(f"field {field.name!r} holds lists of different lengths")
    start = int(offsets[0]) if length else 0
    if start < 0 or start + length * width > child.shape[0]:
        raise ArrowFormatError(f"field {field.name!r}: offsets past the child array")
    return child[start : start + length * width].reshape((length, width) + child.shape[1:])


def _messages(buf: bytes) -> Iterable[Tuple[_Table, memoryview]]:
    """(Message table, body) of each message of an IPC stream, in order."""
    mem = memoryview(buf)
    pos = 0
    while True:
        if pos + 8 > len(buf):
            raise ArrowFormatError("stream ends without its end-of-stream marker")
        marker, size = struct.unpack_from("<Ii", buf, pos)
        if marker != _CONTINUATION:
            raise ArrowFormatError(f"no 0xFFFFFFFF continuation at byte {pos} "
                                   f"(not an Arrow IPC stream, or the pre-0.15 format)")
        pos += 8
        if size == 0:
            return
        msg = _root(bytes(mem[pos : pos + size]))
        pos += size
        version = msg.scalar(0, "<h")
        if version < _MIN_METADATA_VERSION:
            raise ArrowFormatError(f"metadata version {version} is older than V4")
        body_len = msg.scalar(3, "<q")
        if pos + body_len > len(buf):
            raise ArrowFormatError("message body runs past the end of the stream")
        yield msg, mem[pos : pos + body_len]
        pos += body_len


def read_arrow_stream(path: str) -> Dict[str, np.ndarray]:
    """Every column of one Arrow IPC stream file, each record batch's rows
    concatenated in order."""
    with open(path, "rb") as f:
        buf = f.read()
    fields: Optional[List[_Field]] = None
    parts: Dict[str, List[np.ndarray]] = {}
    for msg, body in _messages(buf):
        kind = msg.scalar(1, "<B")
        header = msg.table(2)
        if kind == _HEADER_SCHEMA:
            if fields is not None:
                raise ArrowFormatError("a second schema in one stream")
            if header.scalar(0, "<h") != 0:
                raise ArrowFormatError("big-endian data")
            fields = [_Field(t) for t in header.tables(1)]
            parts = {fd.name: [] for fd in fields}
        elif kind == _HEADER_RECORD_BATCH:
            if fields is None:
                raise ArrowFormatError("a record batch before the schema")
            if header.has(3):
                raise ArrowFormatError("compressed record batch bodies")
            rows = header.scalar(0, "<q")
            nodes = iter(header.structs(1, "<qq"))
            buffers = iter(header.structs(2, "<qq"))
            for fd in fields:
                col = _decode(fd, nodes, buffers, body)
                if col.shape[0] != rows:
                    raise ArrowFormatError(f"column {fd.name!r}: {col.shape[0]} rows in a "
                                           f"batch of {rows}")
                parts[fd.name].append(col)
            if next(nodes, None) is not None or next(buffers, None) is not None:
                raise ArrowFormatError("record batch has field nodes or buffers left over")
        elif kind == _HEADER_DICTIONARY:
            raise ArrowFormatError("dictionary batches")
        else:
            raise ArrowFormatError(f"message header type {kind}")
    if fields is None:
        raise ArrowFormatError("stream has no schema")
    return {name: _concat(cols) for name, cols in parts.items()}


def _concat(cols: Sequence[np.ndarray]) -> np.ndarray:
    if not cols:
        raise ArrowFormatError("stream has no record batch")
    inner = {c.shape[1:] for c in cols if c.shape[0]}
    if len(inner) > 1:
        raise ArrowFormatError(f"record batches of different inner shapes {sorted(inner)}")
    dtypes = {c.dtype.str for c in cols}
    if len(dtypes) > 1:
        raise ArrowFormatError(f"one column in several types {sorted(dtypes)}")
    cols = [c for c in cols if c.shape[0]] or cols[:1]
    return np.concatenate(cols) if len(cols) > 1 else cols[0]


def load_from_disk(path: str, columns: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """The columns (all, or those named) of a dataset directory written by
    `datasets.Dataset.save_to_disk`, its shards in the order `state.json`
    lists them."""
    with open(os.path.join(path, "state.json")) as f:
        state = json.load(f)
    files = [d["filename"] for d in state.get("_data_files") or []]
    if not files:
        raise ArrowFormatError(f"{path}/state.json lists no data files")
    if any(v for k, v in state.items() if k.startswith("_indices")):
        raise ArrowFormatError(f"{path} has an indices mapping (not a flattened dataset)")
    shards = [read_arrow_stream(os.path.join(path, name)) for name in files]
    names = list(columns) if columns is not None else list(shards[0])
    out = {}
    for name in names:
        missing = [f for f, s in zip(files, shards) if name not in s]
        if missing:
            raise KeyError(f"column {name!r} is not in {missing}")
        out[name] = _concat([s[name] for s in shards])
    return out
