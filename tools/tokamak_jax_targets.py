#!/usr/bin/env python3
"""JAX's random targets of the tokamak dataset, as uniforms, for the port to
replay on the card (`tools/tokamak_data_arm.py --targets`).

`safediffcon_tpu.tasks.tokamak.data.generate_tokamak_dataset` draws each
sim's four targets from one key: `rng = PRNGKey(seed)`, then per batch of
`gen_batch` sims `rng, key = split(rng)`, `keys = split(key, n)` (the last
batch is the remainder), and per sim `uniform(key, (4, 3))`, scaled to the
target box and quantized (`solvers/kstar.py::closed_loop_rollout`). Those
12 uniforms per sim are all that is random in JAX's data; the closed loop
is deterministic given them. This tool computes them along that key chain
with the JAX installed here and writes them as one float32 array (N, 4, 3),
N = n_train + n_cal + n_test in the dataset's order, plus a JSON beside it
(`<npy>.json`: the sizes, the JAX version, `jax_threefry_partitionable`,
the array's sha256). They are JAX's key chain as this JAX computes it; a JAX
of another version or flag may draw other values from the same seed.

It imports JAX and the JAX package, so it is not part of the port. On the
CPU, from the repository root:

    JAX_PLATFORMS=cpu python tools/tokamak_jax_targets.py \\
        [--out build/tokamak_jax_targets.npy] [--n-train 48950 --n-cal 1000 --n-test 50] \\
        [--gen-batch 512]
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# closed_loop_rollout's draw: 4 targets (steps 0-30, 31-60, 61-90, 91-120) of 3 values
TARGET_SHAPE = (4, 3)
SEED = 0  # generate_tokamak_dataset's default, the recipe's data seed


def jax_uniforms(n_train: int, n_cal: int, n_test: int, gen_batch: int):
    """(N, 4, 3) float32 numpy uniforms along `generate_tokamak_dataset`'s
    key chain."""
    import jax
    import numpy as np

    total = n_train + n_cal + n_test
    draw = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, TARGET_SHAPE)))
    rng = jax.random.PRNGKey(SEED)
    out, done = [], 0
    while done < total:
        n = min(gen_batch, total - done)
        rng, key = jax.random.split(rng)
        out.append(np.asarray(draw(jax.random.split(key, n))))
        done += n
    return np.concatenate(out).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/tokamak_jax_targets.npy")
    ap.add_argument("--n-train", type=int, default=48950)
    ap.add_argument("--n-cal", type=int, default=1000)
    ap.add_argument("--n-test", type=int, default=50)
    ap.add_argument("--gen-batch", type=int, default=512)
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    u = jax_uniforms(args.n_train, args.n_cal, args.n_test, args.gen_batch)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.save(out, u)
    meta = dict(shape=list(u.shape), n_train=args.n_train, n_cal=args.n_cal,
                n_test=args.n_test, gen_batch=args.gen_batch, seed=SEED,
                jax_version=jax.__version__,
                jax_threefry_partitionable=bool(jax.config.jax_threefry_partitionable),
                sha256=hashlib.sha256(u.tobytes()).hexdigest())
    line = json.dumps(meta)
    Path(f"{out}.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
