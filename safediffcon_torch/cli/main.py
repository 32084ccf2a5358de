"""Unified command line of the PyTorch port.

Port of `safediffcon_tpu/cli/main.py`, which replaces the reference's
per-suite argparse mains and bash sweep wrappers (reference: 1D/train.py,
1D/run_posttrain.py, 1D/run_inference_ft.py, 2d/train_2d.py,
2d/inference_2d.py, tokamak/pretrain.py, tokamak/run_inference.py,
*/scripts/*.sh) with one entry point:

    python -m safediffcon_torch.cli.main <task> <phase> [options]

tasks:  burgers | tokamak | smoke
phases: generate-data | pretrain | posttrain | infft | eval

Every flag of the JAX command line is taken with its name, choices and
default, so a command line carries over unchanged, except:

  --device       a flag JAX lacks (JAX takes its device from the
                 environment): "cuda" by default; with no card visible the
                 command exits with an error unless --device cpu is given.
  --conv-impl    "xla" is cuDNN's F.conv3d, "pallas" the port's kernel K2.
  --steps-per-call  1 by default (JAX: 25 on a TPU, 1 elsewhere; the card is
                 "elsewhere").
  --eval-chunk   50 by default (JAX: 10, sized for a 16 GB chip; an 80 GB
                 H100 holds the reference test set of 50 in one chunk).
  --no-dp, --sp  as in JAX, every phase but generate-data runs data-parallel
                 when more than one card is visible (parallel/mesh.py), but
                 as one process per card: under `torchrun --nproc_per_node=N`
                 each rank joins the NCCL group and runs on cuda:LOCAL_RANK;
                 with no launcher, the command starts one worker per visible
                 card on localhost itself. --sp N splits the UNet3D's frames
                 over N ranks of a 2-D (data, frames) mesh; --no-dp runs each
                 process alone. Only rank 0 writes files and logs INFO lines.
  random draws   a torch.Generator seeded with --seed on the device, where
                 JAX uses PRNGKey(seed).
  checkpoints    the port's own torch.save format (utils/checkpoint.py); the
                 JAX command line's orbax checkpoints are not read.

Results are written as JSON next to the checkpoints, and each run's
arguments under <out>/metadata/<phase>.json; fine-tuned checkpoints embed the
conformal quantile (the reference convention).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import logging
import os
import sys
import time

import torch

from safediffcon_torch.parallel import mesh as pmesh


def _setup_logging():
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
        stream=sys.stdout,
    )


def _save_results(out_dir: str, name: str, payload) -> str:
    path = os.path.join(out_dir, name)
    if pmesh.is_writer():
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=float)
    return path


def _register_run(out_dir: str, args) -> None:
    """Experiment metadata registry (reference convention:
    experiments/metadata/*.json, 1D/train.py:34-50,
    tokamak/inference/pipeline.py:426-443)."""
    import datetime

    meta_path = os.path.join(out_dir, "metadata", f"{args.phase}.json")
    os.makedirs(os.path.dirname(meta_path), exist_ok=True)
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    run_id = f"{args.task}-{args.phase}-{len(meta)}"
    meta[run_id] = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "args": {k: v for k, v in vars(args).items() if v is not None},
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--data", default=None, help="dataset .npz path")
    p.add_argument("--out", default="experiments", help="output/checkpoint dir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--steps", type=int, default=None, help="override step count")
    p.add_argument("--dim", type=int, default=None, help="override model width")
    p.add_argument("--checkpoint", type=int, default=None, help="milestone to load")
    p.add_argument("--n-train", type=int, default=None, help="generate-data: train size")
    p.add_argument("--n-cal", type=int, default=None, help="generate-data: cal size")
    p.add_argument("--n-test", type=int, default=None, help="generate-data: test size")
    p.add_argument("--no-dp", action="store_true",
                   help="disable automatic data parallelism over multiple devices "
                        "(every process then runs alone)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel ranks on the video frame axis "
                        "(smoke/UNet3D): builds a 2-D (data, frames) mesh "
                        "with world_size//sp x sp ranks")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest saved state in --out: "
                        "pretrain restores the latest step milestone; "
                        "posttrain/infft restore epoch-granular phase state "
                        "(params+opt+Q-hat, <out>/<task>-<phase>-state)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="pretrain: optimizer steps per chunk, whose batches cross to "
                        "the device in one copy and run back to back (default 1; JAX "
                        "defaults to 25 on a TPU)")
    p.add_argument("--train-deadline-s", type=float, default=None,
                   help="pretrain: wall-clock budget in seconds — the loop "
                        "stops cleanly at the first chunk boundary past the "
                        "budget and checkpoints the step reached (resume "
                        "with --resume)")
    p.add_argument("--remat-policy", default="full",
                   choices=("full", "save_heavy"),
                   help="smoke pretrain: UNet3D activation checkpointing — 'full' "
                        "(least memory) or 'save_heavy' (keep conv/matmul outputs, "
                        "recompute only elementwise ops)")
    p.add_argument("--conv-impl", default="xla", choices=("xla", "pallas"),
                   help="smoke: 3x3x3 conv implementation — 'xla' is cuDNN's "
                        "F.conv3d, 'pallas' the fused kernel K2 "
                        "(ops/conv3d_mxu.py, csrc/conv3d_wgmma.cu)")
    p.add_argument("--attn-impl", default="packed", choices=("heads", "packed"),
                   help="smoke: UNet3D attention matmul layout (models/unet3d.py); "
                        "checkpoints interchange")
    p.add_argument("--eval-chunk", type=int, default=50,
                   help="smoke: test-set sub-batch per sample->solve->metrics pass "
                        "(device memory scales with it; an 80 GB H100 holds the "
                        "reference test set of 50 in one chunk); 0 = whole test set at once")
    p.add_argument("--cal-chunk", type=int, default=50,
                   help="smoke: calibration sub-batch per device call")
    p.add_argument("--from-phase", default="pretrain",
                   choices=("pretrain", "posttrain", "infft"),
                   help="eval: which phase's checkpoint to load")
    p.add_argument("--ddim-steps", type=int, default=None,
                   help="eval: override the sampler's DDIM step count "
                        "(reference defaults: 200 burgers / 200 tokamak / "
                        "100 smoke)")
    p.add_argument("--model-w", action="store_true",
                   help="burgers pretrain: train the w-only prior model "
                        "p(w | u0, uT) into <out>/burgers-pretrain-w "
                        "(reference is_model_w, 1D/model/diffusion.py:678) "
                        "— the prior for --two-model sampling")
    p.add_argument("--two-model", action="store_true",
                   help="burgers eval: compose the main denoiser with the "
                        "w-only prior from <out>/burgers-pretrain-w "
                        "(reference eval_two_models, "
                        "1D/model/diffusion.py:226-239)")
    p.add_argument("--prior-beta", type=float, default=0.5,
                   help="two-model composition weight beta "
                        "(reference prior_beta, 1D/model/diffusion.py:55)")
    p.add_argument("--normalize-beta", action="store_true",
                   help="two-model: use the normalized composition "
                        "(out - (1-beta)*out_w)/beta")
    p.add_argument("--prior-checkpoint", type=int, default=None,
                   help="two-model: milestone of the w-model checkpoint "
                        "(default: latest in <out>/burgers-pretrain-w)")
    p.add_argument("--checkpoints", default=None,
                   help="eval: sweep milestones — 'LO:HI[:STEP]' (HI inclusive)"
                        " or a comma list '10,20,170'; writes a results table")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the port's own flag: "
                        "without a card the command exits unless --device cpu is given)")


def _resume_dir(args, ckpt_dir):
    """Full-state resume: pretrain() restores step/opt/EMA from the latest
    milestone in this directory when --resume is set."""
    return ckpt_dir if getattr(args, "resume", False) else None


def _phase_state_dir(args, task):
    """Epoch-granular crash resume for the posttrain/InfFT loops: with
    --resume, the phase persists (params, opt moments, Q) per epoch under
    <out>/<task>-<phase>-state and picks up from the latest saved epoch."""
    if not getattr(args, "resume", False):
        return None
    return os.path.join(args.out, f"{task}-{args.phase}-state")


def _train_deadline(args):
    s = getattr(args, "train_deadline_s", None)
    return None if s is None else time.time() + s


def _steps_per_call(args):
    # --steps-per-call 0 or 1 means "no chunking"
    return max(args.steps_per_call, 1)


def _generator(args, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(args.seed)


def _dispatch_load(ds_cls, data_path: str, split: str, **kw):
    """Route --data to the loader matching its on-disk format.

    *.npz           -> native consolidated arrays (`load`)
    *.h5 / *.hdf5   -> reference Burgers HDF5 (`load_h5`; per-split sibling
                       files `burgers_{split}.h5` are resolved automatically,
                       reference: 1D/data/load_hdf5.py:6-57)
    HF dataset dir  -> reference tokamak datasets.load_from_disk layout
                       (`load_hf`, reference: tokamak/data/tokamak_dataset.py:5-56;
                       read by the port's numpy Arrow reader)
    other dir       -> reference smoke per-sim npy-dir layout
                       (`load_sim_dirs`, reference: 2d/ddpm/data_2d.py:43-113)
    """
    if data_path.endswith((".h5", ".hdf5")):
        if not hasattr(ds_cls, "load_h5"):
            raise SystemExit(f"{ds_cls.__name__} has no HDF5 loader")
        path, base = data_path, os.path.basename(data_path)
        for other in ("train", "cal", "test"):
            if other != split and other in base:
                cand = os.path.join(
                    os.path.dirname(data_path), base.replace(other, split))
                if os.path.exists(cand):
                    path = cand
        return ds_cls.load_h5(path, split, **kw)
    if os.path.isdir(data_path):
        if os.path.exists(os.path.join(data_path, "dataset_info.json")) or os.path.exists(
            os.path.join(data_path, "state.json")
        ):
            if not hasattr(ds_cls, "load_hf"):
                raise SystemExit(f"{ds_cls.__name__} has no HF-dataset loader")
            return ds_cls.load_hf(data_path, split, **kw)
        if not hasattr(ds_cls, "load_sim_dirs"):
            raise SystemExit(f"{ds_cls.__name__} has no sim-dir loader")
        return ds_cls.load_sim_dirs(data_path, split, **kw)
    return ds_cls.load(data_path, split, **kw)


def _on(device, state_dict):
    """A checkpoint's state_dict (loaded to the CPU) on `device`."""
    return {k: v.to(device) for k, v in state_dict.items()}


def _load_params(args, out_dir, task, step=None, device="cpu"):
    """Model weights (the EMA where saved) on `device` and Q, if present, of
    the requested phase's milestone: `step`, else --checkpoint, else the
    latest."""
    from safediffcon_torch.utils.checkpoint import latest_step, load_checkpoint

    phase = getattr(args, "from_phase", "pretrain")
    if args.phase in ("posttrain", "infft"):
        phase = "pretrain"  # finetuning always starts from the pretrain ckpt
    ckpt_dir = os.path.join(out_dir, f"{task}-{phase}")
    if step is None:  # explicit None checks: milestone 0 is a valid step
        step = args.checkpoint
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(
            f"no checkpoint found in {ckpt_dir} — run `{task} {phase}` first "
            f"(or pass --checkpoint/--out)"
        )
    restored = load_checkpoint(ckpt_dir, step)
    params = restored.get("ema_params", restored.get("params"))
    return _on(device, params), restored.get("Q")


def _parse_checkpoints(spec: str):
    """'LO:HI[:STEP]' (HI inclusive) or comma list -> milestone list."""
    try:
        if ":" in spec:
            parts = [int(x) for x in spec.split(":")]
            lo, hi = parts[0], parts[1]
            stride = parts[2] if len(parts) > 2 else 1
            if stride <= 0:
                raise ValueError(f"stride must be positive, got {stride}")
            steps = list(range(lo, hi + 1, stride))
        else:
            steps = [int(x) for x in spec.split(",")]
    except ValueError as e:
        raise SystemExit(
            f"bad --checkpoints spec {spec!r} (want 'LO:HI[:STEP]' or a comma "
            f"list): {e}"
        )
    if not steps:
        raise SystemExit(
            f"--checkpoints spec {spec!r} selects no milestones (LO > HI?)"
        )
    return steps


def _eval_sweep(args, task: str, eval_one) -> None:
    """Evaluate one checkpoint or a --checkpoints sweep with a results table
    (reference: 1D/run_eval.py + 1D/eval.py:129-153).

    eval_one(step_or_None) -> metrics dict. Per-checkpoint failures are
    recorded and the sweep continues (reference: 1D/run_eval.py:27-32).
    """
    if not args.checkpoints:
        metrics = eval_one(None)
        print(_save_results(args.out, f"{task}_eval_results.json", metrics))
        print(json.dumps(metrics, default=float))
        return

    table = {}
    for step in _parse_checkpoints(args.checkpoints):
        logging.info("evaluating %s checkpoint %d", task, step)
        try:
            table[step] = eval_one(step)
        except Exception as e:  # keep sweeping past broken milestones
            logging.warning("checkpoint %d failed: %s", step, e)
            table[step] = {"error": str(e)}
    path = _save_results(args.out, f"{task}_eval_sweep.json", table)

    cols = sorted({
        k for m in table.values()
        for k, v in m.items() if isinstance(v, (int, float))
    })
    print("\t".join(["checkpoint"] + cols))
    for step, m in table.items():
        row = [str(step)] + [
            f"{m[k]:.6g}" if isinstance(m.get(k), (int, float)) else "-"
            for k in cols
        ]
        print("\t".join(row))
    print(path)


def _generate_kw(args) -> dict:
    return {k: v for k, v in dict(n_train=args.n_train, n_cal=args.n_cal,
                                   n_test=args.n_test).items() if v is not None}


def run_burgers(args, device) -> int:
    from safediffcon_torch.tasks.burgers.config import (
        BurgersConformalConfig, BurgersInfFTConfig, BurgersPostTrainConfig,
        BurgersPretrainConfig,
    )
    from safediffcon_torch.tasks.burgers.data import BurgersDataset, generate_burgers_dataset
    from safediffcon_torch.tasks.burgers import pipeline as P
    from safediffcon_torch.utils.checkpoint import save_finetuned

    data_path = args.data or os.path.join(args.out, "burgers.npz")
    if args.phase == "generate-data":
        generate_burgers_dataset(data_path, seed=args.seed, device=device, **_generate_kw(args))
        print(f"wrote {data_path}")
        return 0

    dim = args.dim or 128
    if args.phase == "pretrain":
        cfg = BurgersPretrainConfig(dim=dim, seed=args.seed)
        # --model-w trains the w-only prior into its own checkpoint dir
        # (the two-model composition's second model)
        suffix = "-w" if args.model_w else ""
        ckpt_dir = os.path.join(args.out, f"burgers-pretrain{suffix}")
        train = _dispatch_load(BurgersDataset, data_path, "train")
        P.pretrain(cfg, train, num_steps=args.steps,
                   checkpoint_dir=ckpt_dir,
                   resume_dir=_resume_dir(args, ckpt_dir),
                   steps_per_call=_steps_per_call(args),
                   deadline=_train_deadline(args),
                   model_w=args.model_w, device=device)
        return 0

    def _with_prior(p):
        """--two-model: pair the main params with the w-only prior's."""
        if not args.two_model:
            return p
        from safediffcon_torch.utils.checkpoint import latest_step, load_checkpoint

        w_dir = os.path.join(args.out, "burgers-pretrain-w")
        step = args.prior_checkpoint
        if step is None:
            step = latest_step(w_dir)
        if step is None:
            raise SystemExit(
                f"--two-model: no w-model checkpoint in {w_dir} — run "
                "`burgers pretrain --model-w` first")
        restored = load_checkpoint(w_dir, step)
        return (p, _on(device, restored.get("ema_params", restored.get("params"))))

    params = None
    if not (args.phase == "eval" and args.checkpoints):
        # sweep mode reloads per milestone; skip the redundant upfront load
        params, _ = _load_params(args, args.out, "burgers", device=device)
        params = _with_prior(params)

    def _ccfg(base=None):
        c = base or BurgersConformalConfig()
        if args.ddim_steps:
            c = dataclasses.replace(c, ddim_sampling_steps=args.ddim_steps)
        return c

    pipe_kw = dict(dim=dim, two_model=args.two_model,
                   prior_beta=args.prior_beta,
                   normalize_beta=args.normalize_beta, device=device)
    if args.two_model and args.phase != "eval":
        raise SystemExit("--two-model is a sampling/eval surface (the "
                         "reference composes models at inference only); "
                         "finetune the main model, then eval --two-model")
    cal = _dispatch_load(BurgersDataset, data_path, "cal")
    test = _dispatch_load(BurgersDataset, data_path, "test")

    def make_pipe():
        return P.BurgersPipeline(_ccfg(), **pipe_kw)

    if args.phase == "posttrain":
        cfg = BurgersPostTrainConfig(seed=args.seed)
        finetune = _dispatch_load(BurgersDataset, data_path, "train",
                                  subset=cfg.finetune_subset_size)
        state, Q, metrics = P.posttrain_resilient(
            cfg, make_pipe, params, finetune, cal, test,
            finetune_steps=args.steps,
            state_dir=_phase_state_dir(args, "burgers"))
        save_finetuned(os.path.join(args.out, "burgers-posttrain"), state.ema_params, Q)
        print(_save_results(args.out, "burgers_posttrain_results.json", metrics))
    elif args.phase == "infft":
        cfg = BurgersInfFTConfig(seed=args.seed)
        state, Q, metrics = P.inference_finetune_resilient(
            cfg, make_pipe, params, cal, test,
            state_dir=_phase_state_dir(args, "burgers"))
        save_finetuned(os.path.join(args.out, "burgers-infft"), state.ema_params, Q)
        print(_save_results(args.out, "burgers_infft_results.json", metrics))
    elif args.phase == "eval":
        pipe = make_pipe()

        def eval_one(step):
            p = params if step is None else _with_prior(
                _load_params(args, args.out, "burgers", step=step, device=device)[0])
            Q = pipe.calibrate(p, cal.data, torch.zeros((), device=device),
                               generator=_generator(args, device))
            metrics = pipe.evaluate(p, test, Q, generator=_generator(args, device))
            metrics["quantile"] = float(Q)
            return metrics

        _eval_sweep(args, "burgers", eval_one)
    else:
        raise SystemExit(f"unknown phase {args.phase}")
    return 0


def run_tokamak(args, device) -> int:
    from safediffcon_torch.tasks.tokamak import (
        TokamakConformalConfig, TokamakDataset, TokamakPipeline,
        TokamakPretrainConfig, finetune_config, generate_tokamak_dataset,
        posttrain_config, pretrain, run_inference_resilient,
    )
    from safediffcon_torch.utils.checkpoint import save_finetuned

    data_path = args.data or os.path.join(args.out, "tokamak.npz")
    if args.phase == "generate-data":
        generate_tokamak_dataset(data_path, seed=args.seed, device=device, **_generate_kw(args))
        print(f"wrote {data_path}")
        return 0

    dim = args.dim or 128
    if args.phase == "pretrain":
        cfg = TokamakPretrainConfig(dim=dim, seed=args.seed)
        ckpt_dir = os.path.join(args.out, "tokamak-pretrain")
        train = _dispatch_load(TokamakDataset, data_path, "train")
        pretrain(cfg, train, num_steps=args.steps, checkpoint_dir=ckpt_dir,
                 resume_dir=_resume_dir(args, ckpt_dir),
                 steps_per_call=_steps_per_call(args),
                 deadline=_train_deadline(args), device=device)
        return 0

    params = None
    if not (args.phase == "eval" and args.checkpoints):
        # sweep mode reloads per milestone; skip the redundant upfront load
        params, _ = _load_params(args, args.out, "tokamak", device=device)

    cal = _dispatch_load(TokamakDataset, data_path, "cal")
    test = _dispatch_load(TokamakDataset, data_path, "test")
    if args.phase in ("posttrain", "infft"):
        cfg = posttrain_config() if args.phase == "posttrain" else finetune_config()
        train = _dispatch_load(TokamakDataset, data_path, "train")
        params, Q, metrics = run_inference_resilient(
            cfg, lambda: TokamakPipeline(cfg.conformal, dim=dim, device=device),
            params, train, cal, test, state_dir=_phase_state_dir(args, "tokamak"))
        save_finetuned(os.path.join(args.out, f"tokamak-{args.phase}"), params, Q)
        print(_save_results(args.out, f"tokamak_{args.phase}_results.json", metrics))
    elif args.phase == "eval":
        ccfg = TokamakConformalConfig()
        if args.ddim_steps:
            ccfg = dataclasses.replace(ccfg, ddim_sampling_steps=args.ddim_steps)
        pipe = TokamakPipeline(ccfg, dim=dim, device=device)

        def eval_one(step):
            p = params if step is None else _load_params(args, args.out, "tokamak", step=step,
                                                         device=device)[0]
            Q = pipe.calibrate(p, cal, torch.zeros((), device=device),
                               generator=_generator(args, device))
            metrics = pipe.evaluate(p, test, Q, generator=_generator(args, device))
            metrics["quantile"] = float(Q)
            return metrics

        _eval_sweep(args, "tokamak", eval_one)
    else:
        raise SystemExit(f"unknown phase {args.phase}")
    return 0


def run_smoke(args, device) -> int:
    from safediffcon_torch.tasks.smoke import (
        SmokeConformalConfig, SmokeDataset, SmokePipeline, SmokePretrainConfig,
        finetune_config, generate_smoke_dataset, posttrain_config, pretrain,
        run_inference_resilient,
    )
    from safediffcon_torch.utils.checkpoint import save_finetuned

    data_path = args.data or os.path.join(args.out, "smoke.npz")
    if args.phase == "generate-data":
        generate_smoke_dataset(data_path, seed=args.seed, device=device, **_generate_kw(args))
        print(f"wrote {data_path}")
        return 0

    dim = args.dim or 64
    if args.phase == "pretrain":
        cfg = SmokePretrainConfig(dim=dim, seed=args.seed,
                                  remat_policy=args.remat_policy,
                                  conv_impl=args.conv_impl,
                                  attn_impl=args.attn_impl)
        ckpt_dir = os.path.join(args.out, "smoke-pretrain")
        train = _dispatch_load(SmokeDataset, data_path, "train")
        pretrain(cfg, train, num_steps=args.steps, checkpoint_dir=ckpt_dir,
                 resume_dir=_resume_dir(args, ckpt_dir),
                 steps_per_call=_steps_per_call(args),
                 deadline=_train_deadline(args), device=device)
        return 0

    params = None
    if not (args.phase == "eval" and args.checkpoints):
        # sweep mode reloads per milestone; skip the redundant upfront load
        params, _ = _load_params(args, args.out, "smoke", device=device)

    # chunk sizes bound the device memory of a sampling pass; 0 = unchunked
    chunk_kw = dict(eval_chunk=args.eval_chunk or None,
                    cal_chunk=args.cal_chunk or None, device=device)
    cal = _dispatch_load(SmokeDataset, data_path, "cal")
    test = _dispatch_load(SmokeDataset, data_path, "test")
    if args.phase in ("posttrain", "infft"):
        cfg = posttrain_config() if args.phase == "posttrain" else finetune_config()
        train = _dispatch_load(SmokeDataset, data_path, "train")
        params, Q, metrics = run_inference_resilient(
            cfg, lambda: SmokePipeline(
                cfg.conformal, dim=dim, attn_impl=args.attn_impl,
                finetune_set="test" if cfg.backward_finetune else "train", **chunk_kw),
            params, train, cal, test, state_dir=_phase_state_dir(args, "smoke"))
        save_finetuned(os.path.join(args.out, f"smoke-{args.phase}"), params, Q)
        print(_save_results(args.out, f"smoke_{args.phase}_results.json", metrics))
    elif args.phase == "eval":
        ccfg = SmokeConformalConfig()
        if args.ddim_steps:
            ccfg = dataclasses.replace(ccfg, ddim_sampling_steps=args.ddim_steps)
        pipe = SmokePipeline(ccfg, dim=dim, attn_impl=args.attn_impl, **chunk_kw)

        def eval_one(step):
            p = params if step is None else _load_params(args, args.out, "smoke", step=step,
                                                         device=device)[0]
            pipe.model.load_state_dict(p)
            Q = pipe.calibrate(cal, torch.zeros((), device=device),
                               generator=_generator(args, device))
            metrics = pipe.evaluate(test, Q, generator=_generator(args, device))
            metrics["quantile"] = float(Q)
            return metrics

        _eval_sweep(args, "smoke", eval_one)
    else:
        raise SystemExit(f"unknown phase {args.phase}")
    return 0


TASKS = {"burgers": run_burgers, "tokamak": run_tokamak, "smoke": run_smoke}
PHASES = ("generate-data", "pretrain", "posttrain", "infft", "eval")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="safediffcon_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("task", choices=sorted(TASKS))
    parser.add_argument("phase", choices=PHASES)
    _add_common(parser)
    return parser


def _device(args) -> torch.device:
    """The device to run on: a CUDA card must be visible for --device cuda
    (there is no fall-back to the CPU); a rank of a launch takes
    cuda:LOCAL_RANK."""
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is visible; pass "
                             "--device cpu to run on the CPU")
        if "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def _data_parallel(args) -> bool:
    return not args.no_dp and args.phase != "generate-data"


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker(local_rank: int, argv, world: int, port: int) -> None:
    """One rank of `_spawn_workers`: torchrun's environment, then `main`."""
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def _spawn_workers(argv, world: int) -> int:
    """Run the command as `world` ranks on this host, one per card: the
    JAX command line's data parallelism by default over every visible
    device. A rank that fails ends the others; returns 1 then."""
    import torch.multiprocessing as mp

    logging.info("%d CUDA devices visible: starting one rank per card", world)
    try:
        mp.start_processes(_worker, args=(list(argv), world, _free_port()), nprocs=world,
                           start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        logging.error("a rank failed, every rank was stopped: %s", e)
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    _setup_logging()
    launched = "WORLD_SIZE" in os.environ  # a rank of torchrun (or of _spawn_workers)
    if (_data_parallel(args) and not launched and args.device == "cuda"
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        return _spawn_workers(argv, torch.cuda.device_count())
    if launched and args.phase == "generate-data" and int(os.environ.get("RANK", 0)):
        return 0  # rank 0 generates the data
    device = _device(args)
    joined = launched and _data_parallel(args) and pmesh.init_distributed(
        backend="nccl" if device.type == "cuda" else "gloo")
    try:
        if not pmesh.is_writer():
            logging.getLogger().setLevel(logging.WARNING)
        if _data_parallel(args):
            mesh = pmesh.auto_mesh(sp=args.sp)
            if mesh is not None:
                logging.info("%s mesh active over %d ranks", pmesh.describe(mesh),
                             pmesh.world_size())
        if joined:
            logging.info("rank %d of %d in the %s process group on %s", pmesh.rank(),
                         pmesh.world_size(), torch.distributed.get_backend(), device)
        if pmesh.is_writer():
            _register_run(args.out, args)
        with contextlib.nullcontext() if pmesh.is_writer() else contextlib.redirect_stdout(
                io.StringIO()):
            return TASKS[args.task](args, device)
    finally:
        pmesh.activate_mesh(None)
        if joined:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
