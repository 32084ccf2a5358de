"""2D smoke dataset: generation through the solver, npz splits, and the
reference's per-simulation npy directories.

Port of `generate_smoke_dataset`, `SmokeDataset.load` and
`SmokeDataset.load_sim_dirs` of `safediffcon_tpu/tasks/smoke/data.py` (reference:
2d/apps/a_gen_dataset_128.py:100-345,491-744; record format
2d/ddpm/data_2d.py:43-113): random smoke blobs steered by a 4-phase waypoint
velocity program through the maze, recorded as 32 frames of 64^2
(every 8th 128^2 frame, 2x spatial downsample) + the two absorption rates
tiled over space -> (32, 64, 64, 7) channels-last per sample.

The waypoints come from the same numpy generator as in JAX, so a seed gives
the same blobs and velocity programs in both packages; the full-field control
noise is drawn on the device from a `torch.Generator` seeded with `seed`,
which gives other numbers than JAX's key.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from safediffcon_torch.solvers import smoke as S
from safediffcon_torch.tasks.smoke.task import FRAMES, RESCALER

log = logging.getLogger(__name__)


def _waypoints(rng: np.random.Generator):
    """Random start + waypoint x-positions (reference: exp2_target_128,
    2d/apps/a_gen_dataset_128.py:179-211)."""
    m = 4
    start_x = 2 * round(rng.integers(16 + 2 + m, 112 - 10 - m) / 2)
    start_y = 2 * round(rng.integers(16 + 2 + m, 40 - 10 - m) / 2)
    a = 0 if start_x < 64 - 8 else 1
    t1 = rng.integers(16 + m, 64 - 8) if a == 0 else rng.integers(64, 112 - 8 - m)
    t2 = rng.integers(16 + m, 64 - 8) if a == 0 else rng.integers(64, 112 - 8 - m)
    t3 = rng.integers(50, 80 - 1 - 8)
    end_x = rng.integers(64 - 8, 64 + 8 - 8)
    xs = [int(start_x), int(t1), int(t2), int(t3), int(end_x)]
    ys = [int(start_y), 40, 50, 64, 112]
    return xs, ys


def _velocity_program(rng: np.random.Generator, xs, ys, n_frames: int,
                      y_scale: float = 1.0, min_scale: float = 2.0,
                      max_scale: float = 5.0):
    """Per-frame (vx, vy) targets from the waypoint path
    (reference: get_per_vel, 2d/apps/a_gen_dataset_128.py:130-176)."""
    seg = [np.hypot(xs[i + 1] - xs[i], ys[i + 1] - ys[i]) for i in range(4)]
    total = sum(seg)
    v = total / float(n_frames)
    scale = rng.uniform(min_scale, max_scale)
    vxs = [scale * v * (xs[i + 1] - xs[i]) / seg[i] for i in range(4)]
    vys = [y_scale * v * (ys[i + 1] - ys[i]) / seg[i] for i in range(4)]
    iv = [int(n_frames * seg[i] / total) for i in range(3)]
    bounds = np.cumsum([iv[0] + 1, iv[1], iv[2]])
    phase = np.searchsorted(bounds, np.arange(n_frames), side="right")
    return np.asarray(vxs)[phase], np.asarray(vys)[phase]


def _generate_batch(masks, dens0: np.ndarray, vxs: np.ndarray, vys: np.ndarray,
                    noise: torch.Tensor, *, time_scale: int, space_scale: int, accuracy: float,
                    max_iter: int, backend: str, device, phase) -> Tuple[np.ndarray, np.ndarray]:
    """One batch of sims: the controls N(v, |v|/10) from `noise` (b, T-1, 128,
    128, 2), the rollout, and the (b, n_rec, size, size, 7) records on the
    host; returns (records, mass ratio mass[:, -1] / mass[:, 0] per sim)."""
    b, n_frames = vxs.shape
    size = S.N // space_scale
    lo, hi = 16 // space_scale, 112 // space_scale
    with phase("inputs"):
        v0 = torch.zeros((b, S.N, S.N, 2), device=device)
        v0[..., 1] = 0.8
        vx_t = torch.as_tensor(vxs, device=device)
        vy_t = torch.as_tensor(vys, device=device)
        ctrl = torch.stack([
            vx_t[:, :-1, None, None] * (1 + 0.1 * noise[..., 0]),
            vy_t[:, :-1, None, None] * (1 + 0.1 * noise[..., 1]),
        ], dim=-1)
        del noise
    with phase("rollout"):
        rec = S.smoke_rollout(masks, torch.as_tensor(dens0, device=device), v0, ctrl,
                              accuracy, max_iter, backend=backend)
    with phase("records"):
        ctrl_full = torch.cat([torch.zeros_like(ctrl[:, :1]), ctrl], dim=1)
        # subsample on the device; only the (b, n_rec, size, size) record crosses
        dsub = rec.density[:, ::time_scale, ::space_scale, ::space_scale].cpu().numpy()
        vel = rec.velocity[:, ::time_scale, ::space_scale, ::space_scale].cpu().numpy()
        c_rec = ctrl_full[:, ::time_scale, ::space_scale, ::space_scale].cpu().numpy()
        smoke = rec.smoke_rate[:, ::time_scale].cpu().numpy()
        safe = rec.smoke_safe_rate[:, ::time_scale].cpu().numpy()
        mass_ratio = (rec.mass[:, -1] / rec.mass[:, 0]).cpu().numpy()
        del rec, ctrl, ctrl_full

        c_rec[:, :, lo:hi, lo:hi, :] = 0.0  # indirect control band
        out = np.zeros((b, dsub.shape[1], size, size, 7), np.float32)
        out[:, :, : dsub.shape[2], : dsub.shape[3], 0] = dsub
        out[..., 1] = vel[..., 0]
        out[..., 2] = vel[..., 1]
        out[..., 3] = c_rec[..., 0]
        out[..., 4] = c_rec[..., 1]
        out[..., 5] = smoke[:, :, None, None]
        out[..., 6] = safe[:, :, None, None]
    return out, mass_ratio


def generate_smoke_dataset(
    path: str,
    n_train: int = 512,
    n_cal: int = 200,
    n_test: int = 50,
    seed: int = 0,
    n_frames: int = 256,
    record_frames: int = FRAMES,
    space_scale: int = 2,
    gen_batch: int = 16,
    accuracy: float = 1e-6,
    max_iter: int = 500,
    backend: str = "auto",
    conservation_min: Optional[float] = None,
    conservation_max: Optional[float] = None,
    device="cuda",
    phase_seconds: Optional[Dict[str, float]] = None,
) -> np.ndarray:
    """Generate all splits with the batched rollout on `device` and save one
    npz. backend "auto" is kernel K1 (`solvers.smoke.resolve_backend`).
    Controls are full-field N(v, |v|/10) noise recorded every time_scale
    frames with the interior zeroed (reference: get_envolve,
    2d/apps/a_gen_dataset_128.py:287-313).

    `conservation_min` / `conservation_max`, when set, reject sims whose
    final total mass (bucket-absorbed + in-domain) over the initial one lies
    outside the open interval (min, max): the reference writer's density-sum
    filter (min_sum_rate / max_sum_rate, 2d/apps/a_gen_dataset_128.py:731-741).
    Rejected sims are regenerated until every split is full; after
    20 * total + gen_batch attempted sims it raises RuntimeError. With no
    bound set every sim is kept. Returns the mass ratio of each kept sim, in
    the order of the saved records.

    When `phase_seconds` is a dict, adds the seconds of each phase to it,
    summed over batches, each phase ending in a sync: "inputs" (waypoints,
    control noise), "rollout" (the solver), "records" (subsampling, the
    copy to the host, the record layout) and "save" (the npz)."""

    @contextlib.contextmanager
    def phase(name: str):
        if phase_seconds is None:
            yield
            return
        t = time.perf_counter()
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        phase_seconds[name] = phase_seconds.get(name, 0.0) + time.perf_counter() - t

    masks = S.build_masks(device)
    time_scale = max(n_frames // record_frames, 1)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = n_train + n_cal + n_test
    filtered = conservation_min is not None or conservation_max is not None

    t0 = time.time()
    recs, ratios = [], []
    done = attempted = 0
    while done < total:
        if attempted >= 20 * total + gen_batch:
            raise RuntimeError(
                f"smoke datagen: conservation filter ({conservation_min}, {conservation_max}) "
                f"rejected nearly all of {attempted} generated sims ({done}/{total} kept) — "
                f"bounds too tight")
        b = min(gen_batch, total - done)
        attempted += b
        with phase("inputs"):
            dens0 = np.zeros((b, S.CELLS, S.CELLS), np.float32)
            vxs = np.zeros((b, n_frames), np.float32)
            vys = np.zeros((b, n_frames), np.float32)
            for i in range(b):
                xs, ys = _waypoints(rng)
                dens0[i, ys[0] : ys[0] + 10, xs[0] : xs[0] + 10] = 1.0
                vxs[i], vys[i] = _velocity_program(rng, xs, ys, n_frames)
            noise = torch.randn((b, n_frames - 1, S.N, S.N, 2), generator=gen, device=device)
        out, mass_ratio = _generate_batch(
            masks, dens0, vxs, vys, noise, time_scale=time_scale, space_scale=space_scale,
            accuracy=accuracy, max_iter=max_iter, backend=backend, device=device, phase=phase)
        if filtered:
            keep = np.ones(b, bool)
            if conservation_min is not None:
                keep &= mass_ratio > conservation_min
            if conservation_max is not None:
                keep &= mass_ratio < conservation_max
            if not keep.all():
                log.info("smoke datagen: rejected %d/%d sims (mass ratio outside (%s, %s))",
                         int((~keep).sum()), b, conservation_min, conservation_max)
            out, mass_ratio = out[keep], mass_ratio[keep]
        recs.append(out)
        ratios.append(mass_ratio)
        done += len(out)
        log.info("smoke datagen %d/%d sims (%.2f s/sim)", done, total,
                 (time.time() - t0) / max(done, 1))

    with phase("save"):
        data = np.concatenate(recs)
        splits = {
            "train": data[:n_train],
            "cal": data[n_train : n_train + n_cal],
            "test": data[n_train + n_cal :],
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **{f"{k}_data": v for k, v in splits.items()})
    return np.concatenate(ratios)


def _read_reference_sim(base: str, sim_id: int, frames: int = FRAMES) -> np.ndarray:
    """One reference sim dir -> (frames, 64, 64, 7) physical-unit record.

    Field npys are (H, W, C, T+1); scalar absorption fractions are bucket 1
    of Smoke.npy and region 0 of Smoke_safe.npy, each normalized by the
    row sum and tiled over space (reference: 2d/ddpm/data_2d.py:48-62).
    """
    sim = os.path.join(base, f"sim_{sim_id:06d}")
    d = np.load(os.path.join(sim, "Density.npy")).astype(np.float32)
    v = np.load(os.path.join(sim, "Velocity.npy")).astype(np.float32)
    c = np.load(os.path.join(sim, "Control.npy")).astype(np.float32)
    s_ori = np.load(os.path.join(sim, "Smoke.npy")).astype(np.float32)
    s_safe = np.load(os.path.join(sim, "Smoke_safe.npy")).astype(np.float32)

    # (H, W, 5, T+1) -> (frames, H, W, 5), channel order d, vx, vy, cx, cy
    fields = np.concatenate([d, v, c], axis=2).transpose(3, 0, 1, 2)[:frames]
    s = (s_ori[:, 1] / s_ori.sum(-1))[:frames]
    sf = (s_safe[:, 0] / s_safe.sum(-1))[:frames]
    h, w = fields.shape[1:3]
    tiled = np.broadcast_to(np.stack([s, sf], axis=-1)[:, None, None, :], (frames, h, w, 2))
    return np.concatenate([fields, tiled], axis=-1)


@dataclasses.dataclass
class SmokeDataset:
    """In-memory split: data (N, F, 64, 64, 7) numpy.

    `data` is normalized (/RESCALER); `raw` is physical units (the test
    split of the reference is consumed unscaled, 2d/ddpm/data_2d.py:92-113).
    """

    data: np.ndarray
    raw: np.ndarray

    @classmethod
    def load(cls, path: str, split: str, subset: Optional[int] = None) -> "SmokeDataset":
        with np.load(path) as z:
            raw = z[f"{split}_data"]
        if subset is not None:
            raw = raw[:subset]
        return cls(data=(raw / RESCALER).astype(np.float32, copy=False), raw=raw)

    @classmethod
    def load_sim_dirs(cls, root: str, split: str, n_cal: int = 200,
                      subset: Optional[int] = None, frames: int = FRAMES) -> "SmokeDataset":
        """Read the reference's per-simulation npy-dir layout
        (reference: 2d/ddpm/data_2d.py:43-113): `{root}/{train,test}/
        sim_%06d/{Density,Velocity,Control}.npy` field stacks plus
        `Smoke.npy` / `Smoke_safe.npy` absorption tallies. Train is the train
        dir without its last `n_cal` sims, cal those `n_cal` sims, test the
        test dir (the reference's 19800 / 200 / 50 at full scale)."""
        base = os.path.join(root, "test" if split == "test" else "train")
        ids = sorted(
            int(name[4:]) for name in os.listdir(base)
            if name.startswith("sim_") and os.path.isdir(os.path.join(base, name))
        )
        if split == "train":
            if len(ids) <= n_cal:
                raise ValueError(
                    f"train dir {base} holds {len(ids)} sims but the last n_cal={n_cal} are "
                    f"the calibration split — train and cal must stay disjoint "
                    f"(reference: 2d/ddpm/data_2d.py:31-37)")
            ids = ids[:-n_cal]
        elif split == "cal":
            ids = ids[-n_cal:]
        if subset is not None:
            ids = ids[:subset]
        raw = np.stack([_read_reference_sim(base, sim_id, frames) for sim_id in ids])
        return cls(data=(raw / RESCALER).astype(np.float32, copy=False), raw=raw)

    def __len__(self) -> int:
        return self.data.shape[0]
