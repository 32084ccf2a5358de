"""Process groups and sharding: data parallelism over the batch axis and
sequence parallelism over the UNet3D's video frame axis.

Port of `safediffcon_tpu/parallel/mesh.py`. The JAX package is one process
driving a mesh of devices; XLA inserts the collectives from sharding
annotations. The port runs one process (rank) per card over
`torch.distributed` (NCCL on CUDA, gloo on the CPU), as the reference's
HF-Accelerate DDP did, and writes its collectives out:

  - the mesh is a `DeviceMesh` with the JAX axis names, ("data",) or
    ("data", "frames") (`get_mesh`, `get_mesh_2d`, `auto_mesh`), made
    process-wide by `activate_mesh`;
  - `batch_shard(n)` is this rank's share of a global batch of n along the
    data axis (`BatchShard`): its rows (`take`), the global tensor back on
    every rank (`gather`), random draws taken at the global shape and cut to
    its rows (`generator`, `draws`), and the gradient reduce (`reduce`:
    averaged over data, summed over frames). A batch that the data axis does
    not divide is computed whole on every rank and not reduced, as JAX falls
    back to an unsharded array;
  - `frame_shard(F)` is this rank's share of F frames along the frame axis
    (`FrameShard`), which the UNet3D takes inside its forward: the halo
    exchange of its temporal convs (`halo_exchange`), the statistics of its
    group norms (`all_reduce_sum`), the keys and values of its temporal
    attention (`gather_kv`) and its output (`gather_frames`) are
    differentiable collectives over the frame group.

A sharded run gives the single-device result up to the reassociation of
sums. NCCL groups use the native collectives, which a captured CUDA graph
holds like any other kernel (`graph_collectives`). Any other backend (gloo,
which takes CUDA tensors only for all-reduce and broadcast) all-gathers by
an all-reduce of a zero-filled buffer holding each rank's part in its own
slot, which is exact (x + 0 = x), and reduce-scatters by an all-reduce
followed by the rank's slice (`collective_route` names the route).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
FRAME_AXIS = "frames"

# Process-wide active mesh: the command line activates one when it runs on
# more than one rank, and the trainer and the pipelines then shard over it.
_ACTIVE_MESH = None


def activate_mesh(mesh):
    """Set (or clear, with None) the process-wide mesh; returns the previous one."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    return prev


def active_mesh():
    return _ACTIVE_MESH


# ---------------------------------------------------------------------------
# Process group and mesh
# ---------------------------------------------------------------------------

def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes files (rank 0, or the only process)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (a no-op with one process)."""
    if world_size() > 1:
        dist.barrier()


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> bool:
    """Join the process group of a multi-process launch; returns whether a
    group is joined.

    The world size and rank default to torchrun's WORLD_SIZE and RANK (its
    MASTER_ADDR / MASTER_PORT give the rendezvous, `init_method` "env://"),
    the backend to NCCL when a CUDA card is visible and gloo otherwise.
    Without a launcher's WORLD_SIZE, or with world_size=1 given, it does
    nothing, as JAX skips `jax.distributed.initialize` for one process; a
    launch of one rank joins a group of one. An already joined group is
    kept."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" not in os.environ:
        return False
    n = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    if world_size is not None and n <= 1:
        return False
    r = int(rank if rank is not None else os.environ["RANK"])
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=n,
                            rank=r)
    return True


def _device_type() -> str:
    # a DeviceMesh's device type picks the backend of its sub-groups; gloo
    # groups (also over CUDA tensors) are built as "cpu" meshes
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def get_mesh(n_devices: Optional[int] = None):
    """1-D data-parallel mesh over every rank of the process group."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh spans every rank: {n_devices} asked, {n} in the group")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(DATA_AXIS,))


def get_mesh_2d(dp: int, sp: int):
    """2-D (data, frames) mesh: data parallelism over the batch axis times
    sequence parallelism over the video frame axis of the UNet3D; ranks
    r = d * sp + f, so each frame group is sp consecutive ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if dp * sp != world_size():
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} ranks, the group has "
                         f"{world_size()}")
    return init_device_mesh(_device_type(), (dp, sp), mesh_dim_names=(DATA_AXIS, FRAME_AXIS))


def auto_mesh(min_devices: int = 2, sp: int = 1):
    """Activate a data mesh over every rank when there are at least
    `min_devices` (the command line calls this, so `pretrain`, `calibrate`
    and `evaluate` run data-parallel under a multi-process launch with no
    other change); sp > 1 activates a 2-D (data, frames) mesh with sp ranks
    on the frame axis. Returns the mesh, or None with fewer ranks."""
    n = world_size()
    if sp > 1 and sp > n:
        raise SystemExit(
            f"--sp {sp} exceeds the {n} visible device(s); sequence "
            f"parallelism needs at least sp devices on the frame axis")
    if sp > 1 and n % sp:
        raise SystemExit(f"--sp {sp} does not divide the {n} ranks; every rank belongs to "
                         f"one frame group of sp ranks")
    if n < min_devices:
        return None
    mesh = get_mesh_2d(n // sp, sp) if sp > 1 else get_mesh()
    activate_mesh(mesh)
    return mesh


def axis_size(mesh, axis: str) -> int:
    """Ranks along `axis` of the mesh (1 when it has no such axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def describe(mesh) -> str:
    """'2 data x 2 frames' and the collective route."""
    axes = " x ".join(f"{axis_size(mesh, a)} {a}" for a in mesh.mesh_dim_names)
    return f"{axes} ({dist.get_backend()}, {collective_route(None)})"


# ---------------------------------------------------------------------------
# Collectives (group None: the whole world)
# ---------------------------------------------------------------------------

def collective_route(group) -> str:
    """"native" on an NCCL group; "all-reduce" elsewhere, where the
    all-gather and the reduce-scatter are built from an all-reduce."""
    return "native" if dist.get_backend(group) == "nccl" else "all-reduce"


def graph_collectives(group) -> bool:
    """Whether collectives over `group` can run inside a captured CUDA
    graph: NCCL's can, being kernels on the card that a graph records like
    any other; gloo's run on the host and cannot. False without a process
    group. Every rank of a group gets the same answer, so every rank makes
    the same capture decision."""
    return dist.is_available() and dist.is_initialized() and dist.get_backend(group) == "nccl"


def _stacked_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's x, in rank order, on every rank."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    if collective_route(group) == "native":
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[r] = x
    dist.all_reduce(out, group=group)
    return out


def _stacked_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """x of shape (n, ...): the sum over ranks of x[r] for this rank r."""
    r = dist.get_rank(group)
    x = x.contiguous()
    if collective_route(group) == "native":
        out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x[r]


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along `dim`, in rank order (no autograd)."""
    if dist.get_world_size(group) == 1:
        return x
    parts = _stacked_gather(x, group)
    return torch.cat(parts.unbind(0), dim=dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of x over ranks, cut into world-size chunks along `dim`: this
    rank's chunk (no autograd)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    stacked = torch.stack(x.chunk(n, dim=dim), dim=0)
    return _stacked_reduce_scatter(stacked, group)


def broadcast(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Copy rank `src`'s tensors to every rank, in place, in one bucket."""
    tensors = list(tensors)
    if not tensors or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x, on every rank; its backward is the same
    sum of the cotangents, since every rank's y feeds that rank's part of
    the loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherKeepSlice(torch.autograd.Function):
    """All-gather along `dim`; backward keeps this rank's slice of the
    cotangent. For a result that every rank then uses whole and alike (the
    UNet3D's output: each frame rank computes the same loss on it), the
    cotangent is the same on every rank, so the slice is already the full
    gradient of the rank's part; a reduce-scatter would multiply it by the
    group size."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.length = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.length, ctx.length).contiguous(), None, None


class _GatherSumBack(torch.autograd.Function):
    """All-gather along `dim`; backward reduce-scatters the cotangent (each
    rank used the whole result for its own part of the loss)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _HaloExchange(torch.autograd.Function):
    """x (this rank's frames along `dim`) -> [h frames of the rank before,
    x, h frames of the rank after], zeros at the first and last rank (SAME
    padding). Backward: the halo's cotangent goes back to the rank that owns
    those frames and is added to its gradient."""

    @staticmethod
    def forward(ctx, x, h, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        fl = x.shape[dim]
        if fl < h:
            raise ValueError(f"a halo of {h} frames needs at least {h} frames per rank, got {fl}")
        ctx.h, ctx.dim, ctx.group, ctx.fl = h, dim, group, fl
        edges = torch.cat([x.narrow(dim, 0, h), x.narrow(dim, fl - h, h)], dim=dim)
        got = _stacked_gather(edges, group)  # (n, ..., 2h, ...)
        zeros = torch.zeros_like(edges.narrow(dim, 0, h))
        left = got[r - 1].narrow(dim, h, h) if r > 0 else zeros
        right = got[r + 1].narrow(dim, 0, h) if r < n - 1 else zeros
        return torch.cat([left, x, right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        h, dim, group, fl = ctx.h, ctx.dim, ctx.group, ctx.fl
        n, r = dist.get_world_size(group), dist.get_rank(group)
        shape = list(g.shape)
        shape[dim] = 2 * h
        send = torch.zeros([n] + shape, dtype=g.dtype, device=g.device)
        if r > 0:  # the left halo is rank r-1's last h frames
            send[r - 1].narrow(dim, h, h).copy_(g.narrow(dim, 0, h))
        if r < n - 1:  # the right halo is rank r+1's first h frames
            send[r + 1].narrow(dim, 0, h).copy_(g.narrow(dim, h + fl, h))
        back = _stacked_reduce_scatter(send, group)
        dx = g.narrow(dim, h, fl).clone()
        dx.narrow(dim, 0, h).add_(back.narrow(dim, 0, h))
        dx.narrow(dim, fl - h, h).add_(back.narrow(dim, h, h))
        return dx, None, None, None


# ---------------------------------------------------------------------------
# Frame-axis sequence parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's frames [rank * length, (rank + 1) * length) of a video of
    size * length frames, split over the frame group."""

    group: object
    rank: int
    size: int
    length: int

    @property
    def lo(self) -> int:
        return self.rank * self.length


def frame_shard(n_frames: int, mesh=None) -> Optional[FrameShard]:
    """The frame split of an n_frames video under the active mesh, or None
    (no frame axis, or sp does not divide n_frames: the UNet3D then runs
    every frame on every rank, as JAX leaves such an axis unsharded)."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    sp = axis_size(mesh, FRAME_AXIS)
    if sp <= 1 or n_frames % sp:
        return None
    return FrameShard(mesh.get_group(FRAME_AXIS), mesh.get_local_rank(FRAME_AXIS), sp,
                      n_frames // sp)


def halo_exchange(x: torch.Tensor, h: int, fs: FrameShard, dim: int = 1) -> torch.Tensor:
    """x with h frames of each neighbouring rank on either side (zeros past
    the first and last frame), differentiable."""
    return _HaloExchange.apply(x, h, dim, fs.group)


def all_reduce_sum(x: torch.Tensor, fs: FrameShard) -> torch.Tensor:
    """The sum of x over the frame group, differentiable."""
    return _AllReduceSum.apply(x, fs.group)


def gather_kv(x: torch.Tensor, fs: FrameShard, dim: int) -> torch.Tensor:
    """Keys or values of every frame along `dim`; the backward
    reduce-scatters their cotangents."""
    return _GatherSumBack.apply(x, dim, fs.group)


def gather_frames(x: torch.Tensor, fs: FrameShard, dim: int = 1) -> torch.Tensor:
    """The whole video from each rank's frames; the backward keeps this
    rank's slice (see `_GatherKeepSlice`)."""
    return _GatherKeepSlice.apply(x, dim, fs.group)


# ---------------------------------------------------------------------------
# Data parallelism over the batch axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlicedGenerator:
    """A generator whose draws are taken at the global batch size n and cut
    to rows [lo, hi): the draws of a rank's share of a batch are then the
    rows that a single process draws for them (`randn`, `randint`)."""

    generator: Optional[torch.Generator]
    n: int
    lo: int
    hi: int


def randn(shape, generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """torch.randn of `shape`; a `SlicedGenerator` draws the global shape
    and returns this rank's rows."""
    if isinstance(generator, SlicedGenerator):
        _check_rows(shape, generator)
        full = torch.randn((generator.n,) + tuple(shape[1:]), generator=generator.generator,
                           dtype=dtype, device=device)
        return full[generator.lo : generator.hi].clone()
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def randint(high: int, shape, generator=None, device=None) -> torch.Tensor:
    """torch.randint(0, high) of `shape`, sliced like `randn`."""
    if isinstance(generator, SlicedGenerator):
        _check_rows(shape, generator)
        full = torch.randint(0, high, (generator.n,) + tuple(shape[1:]),
                             generator=generator.generator, device=device)
        return full[generator.lo : generator.hi].clone()
    return torch.randint(0, high, shape, generator=generator, device=device)


def _check_rows(shape, g: SlicedGenerator) -> None:
    if shape[0] != g.hi - g.lo:
        raise ValueError(f"a draw of {shape[0]} rows from a generator sliced to "
                         f"[{g.lo}, {g.hi}) of {g.n}")


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows [lo, hi) of a global batch of n along the data axis
    (all of it, with `group` None, when the batch is not split), and the
    frame split of the model that computes on it (None without one)."""

    n: int
    lo: int
    hi: int
    group: object = None
    dp: int = 1
    frames: Optional[FrameShard] = None

    @property
    def split(self) -> bool:
        return self.group is not None

    def take(self, x, axis: int = 0):
        """This rank's rows of a global tensor or array, a view (x itself
        when not split)."""
        if not self.split:
            return x
        return x[(slice(None),) * axis + (slice(self.lo, self.hi),)]

    def gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The global tensor from each rank's rows, on every rank."""
        return all_gather(x, axis, self.group) if self.split else x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks of a per-rank total (x when not split)."""
        if not self.split:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def generator(self, generator):
        """A generator whose draws are the global batch's, cut to this rank's rows."""
        return SlicedGenerator(generator, self.n, self.lo, self.hi) if self.split else generator

    def draws(self, draws):
        """This rank's rows of handed-in global draws: a tensor, or a tuple or
        list of them (and of lists, as a sampler's step_noise), nested."""
        if not self.split or draws is None:
            return draws
        if isinstance(draws, torch.Tensor):
            return self.take(draws)
        return type(draws)(self.draws(d) for d in draws)

    def local(self, fn, *batch, draws, **kw):
        """fn(*this rank's rows of each tensor of `batch`, init_noise=,
        step_noise= this rank's rows of the whole batch's sampler draws
        (init, steps), **kw): how a call handed the whole batch and its
        draws (a captured one) computes its own rows."""
        init, steps = self.draws(draws)
        return fn(*map(self.take, batch), init_noise=init, step_noise=steps, **kw)

    def reduce(self, loss: torch.Tensor,
               grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The global loss and gradients from this rank's: averaged over the
        data ranks (each computed the mean over its rows), summed over the
        frame ranks (each holds its frames' part of the gradient; the loss,
        computed from the gathered output, is the same on each). One
        flattened all-reduce; nothing moves when the batch is whole on every
        rank and the frames are not split."""
        grads, loss = list(grads), loss.detach()
        if not (self.split or self.frames):
            return loss, grads
        if self.split and self.frames:
            group = None  # the whole mesh: every data rank times every frame rank
        else:
            group = self.group if self.split else self.frames.group
        with_loss = self.frames is None
        parts = ([loss.reshape(1).to(grads[0].dtype)] if with_loss else []) + [
            g.reshape(-1) for g in grads]
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        if self.split:
            flat /= self.dp
        out = list(flat.split([p.numel() for p in parts]))
        if with_loss:
            # a copy: a view would keep the whole flattened gradient alive
            # for as long as the caller keeps the loss
            loss = out.pop(0).reshape(()).clone()
        elif self.split:
            loss = self.sum(loss) / self.dp
        return loss, [v.view_as(g) for v, g in zip(out, grads)]


def batch_shard(n: int, frames: Optional[int] = None, mesh=None) -> BatchShard:
    """This rank's share of a global batch of n under the active mesh (the
    whole batch without one, or where the data axis does not divide n);
    `frames`, the video length of a UNet3D batch, adds the frame split."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    fs = frame_shard(frames, mesh) if frames else None
    dp = axis_size(mesh, DATA_AXIS)
    if dp <= 1 or n % dp:
        return BatchShard(n, 0, n, frames=fs)
    r = mesh.get_local_rank(DATA_AXIS)
    m = n // dp
    return BatchShard(n, r * m, (r + 1) * m, mesh.get_group(DATA_AXIS), dp, fs)


def maybe_shard(x, axis: int = 0, mesh=None, video: bool = False):
    """This rank's slice of `x` along `axis` over the data axis and, with
    video=True on a 2-D mesh, along `axis + 1` over the frame axis; an axis
    the mesh does not divide stays whole, and without a mesh x is returned
    as a tensor. The pipelines take the batch slice only (`batch_shard`):
    the UNet3D splits the frames itself."""
    x = torch.as_tensor(x)
    sh = batch_shard(x.shape[axis], mesh=mesh)
    out = sh.take(x, axis)
    fs = frame_shard(x.shape[axis + 1], mesh) if video and x.dim() > axis + 1 else None
    if fs is not None:
        out = out.narrow(axis + 1, fs.lo, fs.length)
    return out


def gather(x: torch.Tensor, n: int, axis: int = 0, mesh=None) -> torch.Tensor:
    """The global tensor of n rows along `axis` from `maybe_shard`'s slice
    (over the data axis), on every rank."""
    return batch_shard(n, mesh=mesh).gather(x, axis)


def maybe_replicate(tensors: Sequence[torch.Tensor], mesh=None) -> None:
    """Make rank 0's tensors (parameters, optimizer moments) every rank's,
    in place; a no-op without an active mesh."""
    mesh = mesh if mesh is not None else _ACTIVE_MESH
    if mesh is not None:
        broadcast(tensors)


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Pad the batch axis up to a multiple (for even sharding) by repeating
    the last row; returns (padded, real_count)."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), n
