"""A CPU stand-in for CUDA graph capture and replay, for the tests of the
port's captured calls (`core/train.py::CapturedCall`, `StaticCall`,
`ChunkGraph` and the pipelines that use them).

`install(monkeypatch)` replaces `torch.cuda.CUDAGraph`, `torch.cuda.graph`,
the stream, event and memory-pool calls, and the port's `graphs_on` gate,
so that a CPU pipeline takes its captured route (`replays` counts the
replays of a pipeline's graphs, also of those a phase freed as it ended).
Capturing records every ATen operation the captured function runs (forward
and backward) with the tensors it read and wrote, then puts back every
tensor the capture wrote and every generator it drew from: as on the card,
a capture computes nothing. A replay runs the recorded operations again on
the same tensors, writing each result into the tensor the capture produced.
So, as a CUDA graph, a replay reads its inputs from the tensors of the
capture: a value the caller forgot to copy into a static buffer, a Python
number or a weights dict bound at capture time is stale in the replay, and
the test sees the mismatch. Reading a tensor's value on the host
(`.item()`, `bool(t)`, `torch.equal`, `nonzero`) or making a tensor from
host data (other than a number) inside a capture raises, as the card's
capture would fail. A collective (gloo's, on a rank of a test's process
group) is recorded and replayed like any other operation, as an NCCL
collective is on the card.
"""
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from safediffcon_torch.core import train as core_train

aten = torch.ops.aten
# host reads of device values and data-dependent shapes
HOST_SYNCS = {aten._local_scalar_dense.default, aten.is_nonzero.default, aten.equal.default,
              aten.nonzero.default, aten.masked_select.default}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _wait(out) -> None:
    """Wait for a replayed collective (a gloo rank runs it on a thread of
    its own; the eager call's wrapper waited for it, which is no ATen op)."""
    if isinstance(out, (list, tuple)):
        for v in out:
            _wait(v)
    elif isinstance(out, torch.ScriptObject) and hasattr(out, "wait"):
        out.wait()  # a c10d operation's Work


def _assign(out, new) -> None:
    """Write a replayed result into the tensor(s) the capture produced."""
    if isinstance(out, torch.Tensor):
        if not (out.data_ptr() == new.data_ptr() and out.stride() == new.stride()):
            out.copy_(new)
    elif isinstance(out, (list, tuple)):
        for o, n in zip(out, new):
            _assign(o, n)


class RecordedGraph:
    """Stands in for torch.cuda.CUDAGraph; `made` lists every one made since
    `install`."""

    made: list = []

    def __init__(self, keep_graph: bool = False):
        type(self).made.append(self)
        self.ops = []
        self.generators = []
        self.replays = 0

    def register_generator_state(self, g):
        self.generators.append(g)

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                new = func(*args, **kwargs)
                _wait(new)
                _assign(out, new)
        self.replays += 1


class _Recorder(TorchDispatchMode):
    def __init__(self, graph: RecordedGraph):
        super().__init__()
        self.graph = graph
        self.written = {}  # id -> (tensor, its value before the capture)
        self.generators = {}  # id -> (generator, its state before the capture)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_SYNCS:
            raise RuntimeError(f"{func} inside a captured call")
        if func is aten.lift_fresh.default and args[0].dim():
            # host data becoming a tensor (a 0-d one is a number the card's
            # kernels take as an argument, as in `x[i] = 0.0`)
            raise RuntimeError("a tensor made from host data inside a captured call")
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in _tensors(value):
                    if id(t) not in self.written:
                        self.written[id(t)] = (t, t.detach().clone())
        g = kwargs.get("generator")
        if g is not None and id(g) not in self.generators:
            self.generators[id(g)] = (g, g.get_state())
        out = func(*args, **kwargs)
        self.graph.ops.append((func, args, kwargs, out))
        return out

    def undo(self):
        with torch.no_grad():
            for t, before in self.written.values():
                t.copy_(before)
        for g, state in self.generators.values():
            g.set_state(state)


@contextlib.contextmanager
def _graph(cuda_graph, pool=None, stream=None, **kw):
    rec = _Recorder(cuda_graph)
    with rec:
        yield
    rec.undo()


class _Stream:
    def wait_stream(self, other):
        pass


class _Event:
    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


def install(monkeypatch, on: bool = True) -> None:
    """Route the port's captured calls through the stand-in (`on`), or keep
    every call eager (the gate closed) with the stand-in still in place."""
    RecordedGraph.made.clear()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph", _graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(core_train, "graphs_on", (lambda device: on))
    CLEARED.clear()
    clear = core_train.Graphs.clear

    def kept_clear(self):
        CLEARED.setdefault(id(self), []).extend(self.calls.items())
        clear(self)

    monkeypatch.setattr(core_train.Graphs, "clear", kept_clear)


# id of a `Graphs` -> the (key, StaticCall) pairs its `clear` freed
CLEARED: dict = {}


def replays(pipe, kind=None) -> int:
    """The replays of a pipeline's graphs (of the calls of `kind` only, if
    given), those freed at the end of a phase included."""
    calls = list(pipe.graphs.calls.items()) + CLEARED.get(id(pipe.graphs), [])
    return sum(cc.graph.replays for key, call in calls if kind is None or key[0] == kind
               for _, cc in call.graphs.values() if cc.graph is not None)
