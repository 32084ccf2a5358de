"""Multi-process helpers of the port's parallel tests (not a test module).

`run_ranks(fn, world, tmp_path, *args)` starts `world` spawned processes
that join one gloo process group (a file:// rendezvous under tmp_path, so
concurrent test workers never share a TCP port), run `fn(*args)` on each
rank and return every rank's result, in rank order. The functions the ranks
run live here, so that a spawned process imports them by name; they import
torch and the port only, never JAX.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import torch

TIMEOUT_S = 240


def _entry(rank, world, init_file, fn, args, out_dir, mesh_shape):
    import torch.distributed as dist

    from safediffcon_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        if mesh_shape == "env":  # torchrun's variables only: fn joins the group
            os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
            args = (init_file,) + tuple(args)
        else:
            dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                    world_size=world)
        if mesh_shape not in (None, "env"):
            dp, sp = mesh_shape
            pmesh.activate_mesh(pmesh.get_mesh_2d(dp, sp) if sp > 1 else pmesh.get_mesh())
        result = fn(*args)
        torch.save({"ok": result}, path)
    except BaseException:  # reported to the parent, which fails the test
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, mesh_shape=(None, None)):
    """fn(*args) on `world` gloo ranks; mesh_shape (dp, sp) activates that
    mesh first ((dp, 1): the 1-D data mesh), None activates none, and "env"
    joins no group but sets torchrun's RANK / WORLD_SIZE and passes the
    rendezvous file to fn first."""
    if mesh_shape == (None, None):
        mesh_shape = (world, 1)
    out_dir = str(tmp_path / f"ranks-{fn.__name__}-{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, world, init_file, fn, args, out_dir,
                                                mesh_shape))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) if os.path.exists(path) else {
            "error": f"rank {r} wrote no result"}
        if "error" in got:
            raise AssertionError(f"rank {r} failed:\n{got['error']}")
        results.append(got["ok"])
    if alive:
        raise AssertionError(f"{len(alive)} rank(s) did not finish in {TIMEOUT_S} s")
    return results


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def mesh_helpers():
    """What the mesh helpers return on this rank."""
    from safediffcon_torch.parallel import mesh as pmesh

    x = torch.arange(8 * 4 * 3, dtype=torch.float32).reshape(8, 4, 3)
    mesh = pmesh.active_mesh()
    sh = pmesh.batch_shard(8, frames=4)
    local = pmesh.maybe_shard(x)
    video = pmesh.maybe_shard(x, video=True)
    odd = pmesh.maybe_shard(x[:7])
    kb = pmesh.maybe_shard(x.reshape(2, 4, 4, 3)[:, :, :3], axis=1)
    gathered = pmesh.gather(local * 2, 8)
    bcast = [torch.full((3,), float(pmesh.rank())), torch.full((2, 2), 10.0 + pmesh.rank())]
    pmesh.maybe_replicate(bcast)
    g = pmesh.randn((sh.hi - sh.lo, 5), sh.generator(torch.Generator().manual_seed(3)))
    ti = pmesh.randint(10, (sh.hi - sh.lo,), sh.generator(torch.Generator().manual_seed(4)))
    return dict(
        rank=pmesh.rank(), data=pmesh.axis_size(mesh, pmesh.DATA_AXIS),
        frames=pmesh.axis_size(mesh, pmesh.FRAME_AXIS), rows=(sh.lo, sh.hi),
        frame_lo=None if sh.frames is None else sh.frames.lo,
        local=local.numpy(), video=video.numpy(), odd=odd.numpy(), kb=kb.numpy(),
        gathered=gathered.numpy(), bcast=[b.numpy() for b in bcast], randn=g.numpy(),
        randint=ti.numpy(), route=pmesh.collective_route(None))


def collectives(seed):
    """The differentiable collectives against their single-process forms,
    each with a backward, on the frame group of the active mesh."""
    from safediffcon_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(seed)
    full = torch.as_tensor(rng.normal(size=(2, 8, 3, 2)).astype(np.float32))
    cot = torch.as_tensor(rng.normal(size=(2, 8 + 2, 3, 2)).astype(np.float32))
    fs = pmesh.frame_shard(8)
    lo, fl = fs.lo, fs.length
    x = full.narrow(1, lo, fl).clone().requires_grad_(True)
    y = pmesh.halo_exchange(x, 1, fs)
    # the rank's output rows of the padded whole: frames lo .. lo + fl + 1
    y.backward(cot.narrow(1, lo, fl + 2))
    s = pmesh.all_reduce_sum(x.square().sum(dim=(1, 3), keepdim=True), fs)
    xs = x.detach().clone().requires_grad_(True)
    g_kv = pmesh.gather_kv(xs, fs, 1)
    (g_kv * full).sum().backward()
    xo = x.detach().clone().requires_grad_(True)
    out = pmesh.gather_frames(xo, fs)
    (out * full).sum().backward()
    return dict(lo=lo, fl=fl, halo=y.detach().numpy(), halo_grad=x.grad.numpy(),
                sum=s.detach().numpy(), kv=g_kv.detach().numpy(), kv_grad=xs.grad.numpy(),
                out=out.detach().numpy(), out_grad=xo.grad.numpy())


# ---------------------------------------------------------------------------
# UNet3D under frame-axis sequence parallelism (and data parallelism)
# ---------------------------------------------------------------------------

def unet3d_step(variants, state_dict, x, t, cot):
    """For each (name, UNet3D kwargs): the whole output and the global loss
    and gradients of loss = mean over the batch of sum(out * cot), from this
    rank's rows and frames (`BatchShard.reduce`)."""
    from safediffcon_torch.models.unet3d import UNet3D
    from safediffcon_torch.parallel import mesh as pmesh

    x, t, cot = torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(cot)
    sh = pmesh.batch_shard(x.shape[0], frames=x.shape[1])
    out = {}
    for name, kw in variants:
        net = UNet3D(**kw)
        net.load_state_dict(state_dict)
        params = list(net.parameters())
        y = net(sh.take(x), sh.take(t))
        c = sh.take(cot)
        loss = (y * c).sum() / c.shape[0]
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
        out[name] = dict(out=sh.gather(y.detach()).numpy(), loss=float(loss),
                         grads={k: g.numpy() for (k, _), g in
                                zip(net.named_parameters(), grads)},
                         frames=None if sh.frames is None else sh.frames.length)
    return out


# ---------------------------------------------------------------------------
# Data parallelism: the training loop and the pipelines
# ---------------------------------------------------------------------------

FEAT, BATCH = 4, 4  # the toy model of tests/test_torch_train_loop_options.py


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.eye(FEAT) * 0.5)
        self.b = torch.nn.Parameter(torch.zeros(FEAT))


def train_loop(data, draws, k, num_steps, loop_kw):
    """`run_train_loop` on the toy model: each step's loss takes its rows of
    the step's global draw, and the gradients are reduced over the ranks."""
    from safediffcon_torch.core import train as TT
    from safediffcon_torch.parallel import mesh as pmesh

    sh = pmesh.batch_shard(BATCH)
    model = Toy()
    state = TT.TrainState.create(model, TT.make_optimizer("adam", 1e-2), ema_decay=0.9,
                                 ema_update_every=2)
    it, seen, losses = iter(draws), [], []

    def step_fn(state, batch):
        seen.append(batch.numpy().copy())
        x = batch + 0.1 * sh.draws(next(it))
        loss = torch.mean((x @ model.w + model.b - 1.0) ** 2)
        loss, grads = sh.reduce(loss, torch.autograd.grad(loss, [model.w, model.b]))
        state.apply_gradients(grads)
        return loss

    TT.run_train_loop(step_fn, state, data, batch_take=BATCH, num_steps=num_steps, seed=9,
                      steps_per_call=k, shard=sh, losses=losses, **loop_kw)
    return dict(w=model.w.detach().numpy(), b=model.b.detach().numpy(),
                ema={n: v.numpy() for n, v in state.ema_params.items()},
                seen=seen, losses=[float(v) for v in losses])


def burgers(conf, pipe, sd, cal, test, cal_noise, eval_noise, pretrain_kw, train, step_noise):
    """Burgers calibrate and guided evaluate, from the replayed draws and
    from a seeded generator, and one pretrain step from replayed draws."""
    from safediffcon_torch.tasks.burgers import (
        BurgersConformalConfig, BurgersDataset, BurgersPipeline, BurgersPretrainConfig, pretrain,
    )

    tp = BurgersPipeline(BurgersConformalConfig(**conf), device="cpu", **pipe)
    test = BurgersDataset(*test)
    q = tp.calibrate(sd, cal, 0.0, noise=iter(cal_noise))
    m = tp.evaluate(sd, test, q, noise=iter(eval_noise))
    q_gen = tp.calibrate(sd, cal, 0.0, generator=torch.Generator().manual_seed(5))
    m_gen = tp.evaluate(sd, test, q_gen, generator=torch.Generator().manual_seed(6))
    losses = []
    state = pretrain(BurgersPretrainConfig(**pretrain_kw), BurgersDataset(*train), num_steps=1,
                     params=sd, device="cpu", noise=iter(step_noise), losses=losses)
    return dict(q=float(q), m=m, q_gen=float(q_gen), m_gen=m_gen,
                loss=float(losses[0]),
                params={k: v.detach().numpy() for k, v in state.model.state_dict().items()})


def tokamak(conf, pipe, sd, cal, cal_noise):
    """Tokamak calibrate from the replayed draws and from a generator."""
    from safediffcon_torch.tasks.tokamak import (
        TokamakConformalConfig, TokamakDataset, TokamakPipeline,
    )

    tp = TokamakPipeline(TokamakConformalConfig(**conf), device="cpu", **pipe)
    cal = TokamakDataset(*cal)
    q = tp.calibrate(sd, cal, 0.0, noise=iter(cal_noise))
    q_gen = tp.calibrate(sd, cal, 0.0, generator=torch.Generator().manual_seed(5))
    return dict(q=float(q), q_gen=float(q_gen))


def smoke(conf, pipe, sd, cal, cal_noise):
    """Smoke calibrate from the replayed draws and from a generator."""
    from safediffcon_torch.tasks.smoke import SmokeConformalConfig, SmokeDataset, SmokePipeline

    tp = SmokePipeline(SmokeConformalConfig(**conf), device="cpu", **pipe)
    tp.model.load_state_dict(sd)
    cal = SmokeDataset(*cal)
    q = tp.calibrate(cal, 0.0, noise=iter(cal_noise))
    q_gen = tp.calibrate(cal, 0.0, generator=torch.Generator().manual_seed(5))
    return dict(q=float(q), q_gen=float(q_gen))


def init_two_processes(init_file):
    """`init_distributed` from torchrun's variables: the group forms, and
    an all-reduce and a barrier go through it."""
    import torch.distributed as dist

    from safediffcon_torch.parallel import mesh as pmesh

    joined = pmesh.init_distributed(backend="gloo", init_method=f"file://{init_file}")
    x = torch.tensor([float(pmesh.rank() + 1)])
    dist.all_reduce(x)
    pmesh.barrier()
    mesh = pmesh.auto_mesh()
    out = dict(joined=joined, world=pmesh.world_size(), rank=pmesh.rank(), sum=float(x),
               mesh=pmesh.describe(mesh))
    pmesh.activate_mesh(None)
    dist.destroy_process_group()
    return out


def cli_burgers_pretrain(out):
    """`burgers pretrain` through the command line as a rank of a launch
    (torchrun's variables; the group is already joined), at the CLI tests'
    tiny size: the files this rank saved and the weights it ends with."""
    import functools

    from safediffcon_torch.cli import main as M
    from safediffcon_torch.parallel import mesh as pmesh
    from safediffcon_torch.tasks.burgers import config as BC
    from safediffcon_torch.tasks.burgers import pipeline as BP

    r = pmesh.rank()
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(pmesh.world_size()))
    BC.BurgersPretrainConfig = functools.partial(BC.BurgersPretrainConfig, dim_mults=(1, 2),
                                                 timesteps=20, batch_size=4)
    real_pretrain, real_save, got, saves = BP.pretrain, torch.save, {}, []

    def pretrain(*args, **kw):
        state = real_pretrain(*args, **kw)
        got.update({k: v.detach().numpy().copy() for k, v in state.model.state_dict().items()})
        return state

    def save(obj, f, *args, **kw):
        saves.append(os.path.basename(str(f)))
        return real_save(obj, f, *args, **kw)

    BP.pretrain, torch.save = pretrain, save
    try:
        rc = M.main(["burgers", "pretrain", "--steps", "2", "--steps-per-call", "2", "--out", out,
                     "--device", "cpu", "--dim", "8"])
    finally:
        BP.pretrain, torch.save = real_pretrain, real_save
    return dict(rc=rc, rank=r, saves=saves, params=got)


def _pipeline(task, conf, pipe):
    if task == "burgers":
        from safediffcon_torch.tasks.burgers import BurgersConformalConfig, BurgersPipeline

        return BurgersPipeline(BurgersConformalConfig(**conf), device="cpu", **pipe)
    from safediffcon_torch.tasks.tokamak import TokamakConformalConfig, TokamakPipeline

    return TokamakPipeline(TokamakConformalConfig(**conf), device="cpu", **pipe)


def _split_serving(task, conf, pipe, sd, cal, test, seeds):
    from safediffcon_torch.tasks.burgers import BurgersDataset
    from safediffcon_torch.tasks.tokamak import TokamakDataset

    tp = _pipeline(task, conf, pipe)
    if task == "burgers":
        test = BurgersDataset(*test)
    else:
        cal, test = TokamakDataset(*cal), TokamakDataset(*test)
    q = tp.calibrate(sd, cal, 0.0, generator=torch.Generator().manual_seed(1))
    ms = [tp.evaluate(sd, test, q, generator=torch.Generator().manual_seed(s)) for s in seeds]
    return dict(q=float(q), m=ms, counts=tp.graphs.counts())


def _split_pretrain(task, pretrain_kw, sd, train, num_steps, k):
    if task == "burgers":
        from safediffcon_torch.tasks.burgers import BurgersDataset as D
        from safediffcon_torch.tasks.burgers import BurgersPretrainConfig as C
        from safediffcon_torch.tasks.burgers import pretrain
    else:
        from safediffcon_torch.tasks.tokamak import TokamakDataset as D
        from safediffcon_torch.tasks.tokamak import TokamakPretrainConfig as C
        from safediffcon_torch.tasks.tokamak import pretrain
    losses = []
    state = pretrain(C(**pretrain_kw), D(*train), num_steps=num_steps, params=sd, device="cpu",
                     steps_per_call=k, losses=losses)
    return dict(losses=[float(v) for v in losses],
                loss_bytes=[v.untyped_storage().nbytes() for v in losses],
                params={n: v.detach().numpy() for n, v in state.model.state_dict().items()})


def _split_phase(task, part, conf, pipe, sd, train, cal, test, record=True):
    """A fine-tuning phase as a user runs it: Burgers `posttrain` (two
    epochs of 4 steps in chunks of 2, a recalibration between them) or
    `inference_finetune` (three epochs of one step, each recalibrated; two
    without `record`), or tokamak `run_inference` (one epoch: calibrate, 3
    post-training or backward fine-tuning steps, evaluate). Returns Q-hat, the epoch
    records, the weights and, with `record` (the graph stand-in installed),
    the replays of the step's graph. With `record` the Burgers evaluations
    are left out (their 10,000-step rollout is slow to record); without
    it they run, posttrain's at the end of each epoch."""
    import dataclasses

    tp = _pipeline(task, conf, pipe)
    if record:
        import torch_graph_standin as standin
    if task == "burgers":
        from safediffcon_torch.tasks.burgers import (
            BurgersConformalConfig, BurgersDataset, BurgersInfFTConfig, BurgersPostTrainConfig,
            inference_finetune, posttrain,
        )

        train, cal, test = (BurgersDataset(*d) for d in (train, cal, test))
        conformal = BurgersConformalConfig(**conf)
        if part == "posttrain":
            # without `record`, an evaluation at the end of each epoch
            every = {} if record else dict(finetune_subset_size=16)
            cfg = BurgersPostTrainConfig(conformal=conformal, finetune_epoch=2, finetune_steps=4,
                                         finetune_batch_size=4, finetune_lr=1e-3,
                                         steps_per_call=2, **every)
            state, q, hist = posttrain(cfg, tp, sd, train, cal, test,
                                       eval_every_subset_epoch=not record)
            step = (sum(g.replays for g in standin.RecordedGraph.made)
                    - standin.replays(tp)) if record else None  # the chunk graph's
        else:
            if record:
                tp.evaluate = lambda *a, **kw: {}
            # three epochs recorded, two with their evaluations
            cfg = BurgersInfFTConfig(conformal=conformal, InfFT_iters=4 if record else 3,
                                     finetune_lr=1e-3)
            state, q, hist = inference_finetune(cfg, tp, sd, cal, test)
            step = standin.replays(tp, "infft") if record else None
        params = state.model.state_dict()
        ema = state.ema_params
    else:
        from safediffcon_torch.tasks.tokamak import (
            TokamakConformalConfig, TokamakDataset, finetune_config, posttrain_config,
            run_inference,
        )

        train, cal, test = (TokamakDataset(*d) for d in (train, cal, test))
        base = finetune_config() if part == "backward" else posttrain_config()
        cfg = dataclasses.replace(base, finetune_epoch=1, finetune_steps=3, train_batch_size=4,
                                  finetune_lr=1e-3, conformal=TokamakConformalConfig(**conf))
        params, q, hist = run_inference(cfg, tp, sd, train, cal, test)
        step = (standin.replays(tp, "backward" if part == "backward" else "weighted")
                if record else None)
        ema = {}
    return dict(q=float(q), hist=hist, step_replays=step,
                params={n: v.detach().numpy() for n, v in params.items()},
                ema={n: v.detach().numpy() for n, v in ema.items()})


def split_finetune(task, part, args):
    """A fine-tuning phase (`_split_phase`, or `_smoke_phase` for task
    "smoke"; args as there) eagerly on this rank, or in one process where
    no group is joined, with its evaluations."""
    if task == "smoke":
        return _smoke_phase(part, *args)
    return _split_phase(task, part, *args, record=False)


def _smoke_phase(part, conf, pipe, sd, train, cal, test, inf):
    """Smoke `run_inference` as a user runs it, one epoch: post-training
    (part "weighted", its batches gathered from a device pool) or the
    backward fine-tune (part "backward", on a `finetune_set="test"`
    pipeline), then calibrate and evaluate. Returns Q-hat, the epoch
    records (losses, metrics) and the weights."""
    import dataclasses

    from safediffcon_torch.tasks.smoke import (
        SmokeDataset, SmokePipeline, finetune_config, posttrain_config, run_inference,
    )

    base = finetune_config() if part == "backward" else posttrain_config()
    cfg = dataclasses.replace(base, conformal=dataclasses.replace(base.conformal, **conf),
                              **inf)
    tp = SmokePipeline(cfg.conformal, device="cpu",
                       finetune_set="test" if cfg.backward_finetune else "train", **pipe)
    train, cal, test = (SmokeDataset(*d) for d in (train, cal, test))
    params, q, hist = run_inference(cfg, tp, sd, train, cal, test)
    return dict(q=float(q), hist=hist, params={n: v.detach().numpy() for n, v in params.items()})


def split_capture(task, part, args):
    """A CPU pipeline's calibrate and an evaluate per seed (part "serve",
    args: conf, pipe, sd, cal, test, seeds), a pretrain of num_steps in
    chunks of k (part "train", args: pretrain_kw, sd, train, num_steps, k)
    or a fine-tuning phase (parts "posttrain", "infft", "weighted",
    "backward"; args: conf, pipe, sd, train, cal, test; `_split_phase`)
    through the graph stand-in (`torch_graph_standin`), once per route on
    this rank: "eager" as the gate leaves a batch split over gloo, then
    "captured" as it treats one split over NCCL (`graph_collectives` forced
    open: the collectives recorded and replayed in the graphs). Returns
    each route's results, the pipeline's graph counts and the replays of
    every graph."""
    import pytest

    import torch_graph_standin as standin
    from safediffcon_torch.parallel import mesh as pmesh

    patch = pytest.MonkeyPatch()
    standin.install(patch)
    out = {}
    try:
        for route in ("eager", "captured"):
            if route == "captured":
                patch.setattr(pmesh, "graph_collectives", lambda group: True)
            before = sum(g.replays for g in standin.RecordedGraph.made)
            if part == "serve":
                res = _split_serving(task, *args)
            elif part == "train":
                res = _split_pretrain(task, *args)
            else:
                res = _split_phase(task, part, *args)
            res["replays"] = sum(g.replays for g in standin.RecordedGraph.made) - before
            out[route] = res
    finally:
        patch.undo()
    return out


def reduce_loss(numel):
    """`BatchShard.reduce` of a data-parallel split (this rank's loss and a
    gradient of numel values): the global loss, its storage's bytes and the
    averaged gradient."""
    from safediffcon_torch.parallel import mesh as pmesh

    r = pmesh.rank()
    sh = pmesh.batch_shard(2 * pmesh.world_size())
    loss, (grad,) = sh.reduce(torch.tensor(1.0 + r), [torch.full((numel,), float(r))])
    return dict(loss=float(loss), nbytes=loss.untyped_storage().nbytes(), grad=grad.numpy())
