"""Kernel K1's cluster layout and its banded arithmetic, on the CPU.

The CUDA kernel (`safediffcon_torch/csrc/pressure_cg.cu`) spreads each
chunk of 8 samples over a thread-block cluster: block `rank` owns a band of
grid rows, applies the stencil to it with the row just below and just above
the band taken from its neighbours, and a cluster sum adds the blocks'
partial sums, lane l holding rank l, by a fixed xor butterfly. The kernel
runs only on the card (`chip_smoke.py` holds it against the plain version
there). This file repeats its banded arithmetic in plain PyTorch, float32,
holds it against the JAX Pallas kernels in interpret mode, and checks the
layout function the wrapper launches by."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from safediffcon_tpu.ops.pressure_cg import pressure_solve_pallas
from safediffcon_tpu.solvers import smoke as JS
from safediffcon_torch.ops import pressure_cg as K
from safediffcon_torch.solvers import smoke as TS

torch.set_num_threads(1)

CELLS = 127
LANES = 32
SMEM_PER_BLOCK = 232_448  # Hopper: 227 KB of dynamic shared memory per block


@pytest.fixture(scope="module")
def masks():
    return JS.build_masks(), TS.build_masks("cpu")


def band_rows(lay, n):
    """(ranks, rows + 2): the grid rows each block reads, its band with the
    row below and the row above; n stands for a row outside the grid."""
    return torch.tensor([[y if 0 <= y < n else n for y in range(start - 1, start + lay.rows + 1)]
                         for start, _ in lay.bands(n)])


def banded_stencil(planes, p, rows):
    """A p computed band by band from each band's rows and its two halo rows,
    as the blocks of a cluster compute it; rows past the grid are zero."""
    n = p.shape[-1]
    ext = F.pad(p, (0, 0, 0, 1))[..., rows, :]  # (..., ranks, rows + 2, n)
    diag, up_y, lo_y, up_x, lo_x = F.pad(planes, (0, 0, 0, 1))[:, rows[:, 1:-1], :]
    mid = ext[..., 1:-1, :]
    out = (diag * mid + up_y * ext[..., 2:, :] + lo_y * ext[..., :-2, :]
           + up_x * F.pad(mid[..., 1:], (0, 1)) + lo_x * F.pad(mid[..., :-1], (1, 0)))
    return out.flatten(-3, -2)[..., :n, :]


def block_partials(t, lay, reduce):
    """(chunks, 8, n, n) -> (chunks, ranks): each block's reduction over its
    band of the chunk's 8 samples."""
    n = t.shape[-1]
    bands = F.pad(t, (0, 0, 0, lay.cluster * lay.rows - n))
    bands = bands.unflatten(-2, (lay.cluster, lay.rows)).transpose(1, 2)
    return reduce(bands.flatten(2))


def cluster_total(parts, combine):
    """(chunks, ranks) block partials combined as every warp of the kernel
    combines them: lane l holds rank l's (0 past the cluster), then an xor
    butterfly over the 32 lanes. Every lane ends with the same bits."""
    lanes = F.pad(parts, (0, LANES - parts.shape[-1]))
    swap = torch.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        lanes = combine(lanes, lanes[:, swap ^ o])
    assert (lanes == lanes[:, :1]).all()
    return lanes[:, 0]


def banded_cg(div, guess, planes, accuracy, max_iter, check_every):
    """K1's recurrence (pressure_cg_plain's) with the kernel's banded stencil
    and cluster sums; returns (x, iterations per chunk)."""
    b, n, _ = div.shape
    lay = K.cluster_layout(n)
    rows = band_rows(lay, n)
    chunks = -(-b // K.CHUNK)

    def chunked(t):
        return F.pad(t, (0, 0, 0, 0, 0, chunks * K.CHUNK - b)).reshape(chunks, K.CHUNK, n, n)

    def dot(u, v):
        return cluster_total(block_partials(u * v, lay, lambda t: t.sum(-1)), torch.add)

    def max_abs(u):
        return cluster_total(block_partials(u.abs(), lay, lambda t: t.amax(-1)), torch.maximum)

    def apply_a(p):
        return banded_stencil(planes, p, rows)

    def per_chunk(v):
        return v[:, None, None, None]

    x = chunked(guess)
    r = chunked(div) - apply_a(x)
    m = r
    am = apply_a(m)
    mam, mr, maxr = dot(m, am), dot(m, r), max_abs(r)
    active = torch.ones(chunks, dtype=torch.bool)
    iters = torch.zeros(chunks, dtype=torch.int32)
    it = 0
    while True:
        if it % check_every == 0:
            active = active & (maxr >= accuracy) & (it < max_iter)
            if not bool(active.any()):
                break
        inv = torch.where(mam != 0, 1.0 / torch.where(mam != 0, mam, 1.0), 0.0)
        a = mr * inv
        x_new = x + per_chunk(a) * m
        r_new = r - per_chunk(a) * am
        m_new = r_new + per_chunk(-dot(r_new, am) * inv) * m
        am_new = apply_a(m_new)
        keep = per_chunk(active)
        x, r = torch.where(keep, x_new, x), torch.where(keep, r_new, r)
        m, am = torch.where(keep, m_new, m), torch.where(keep, am_new, am)
        maxr = torch.where(active, max_abs(r_new), maxr)
        mam = torch.where(active, dot(m_new, am_new), mam)
        mr = torch.where(active, dot(m_new, r_new), mr)
        iters += active.to(torch.int32)
        it += 1
    return x.reshape(-1, n, n)[:b], iters


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 15, 16, 17, 63, 64, 65, 120, 121, 126, CELLS, 128])
def test_layout_bands_cover_each_row_once(n):
    lay = K.cluster_layout(n)
    bands = lay.bands(n)
    covered = [y for start, count in bands for y in range(start, start + count)]
    assert covered == list(range(n))
    assert all(count >= 1 for _, count in bands)
    assert lay.cluster == len(bands) <= K.MAX_CLUSTER
    assert lay.smem_bytes <= SMEM_PER_BLOCK


def test_layout_at_the_solver_grid():
    """n = 127: 16 blocks (a non-portable cluster) of 8 rows, the last 7."""
    lay = K.cluster_layout(CELLS)
    assert (lay.cluster, lay.rows) == (16, 8)
    assert lay.bands(CELLS)[-1] == (120, 7)
    # m of 8 samples x 8 rows x 128 columns, 2 x 16 slots, 2 halo rows of
    # 128 x 8, 32 warps' 3 partials, 3 mbarriers
    assert lay.smem_bytes == 4 * (8 * 8 * 128 + 2 * 16 * 4 + 2 * 128 * 8 + 32 * 3) + 3 * 8


@pytest.mark.parametrize("n", [-1, 0, 129, 200, 256])
def test_layout_refuses_what_the_kernel_cannot_take(n):
    assert K.cluster_layout(n) is None


def test_cuda_wrapper_raises_for_a_shape_the_kernel_cannot_take():
    """The wrapper checks the layout before it builds or launches anything;
    pressure_cg still solves such a shape on the CPU with the plain version."""
    rng = np.random.default_rng(0)
    n = 129
    div = torch.from_numpy(rng.normal(size=(2, n, n)).astype(np.float32))
    planes = torch.zeros((5, n, n))
    planes[0] = 4.0
    before = K.pressure_cg_cuda.launches
    with pytest.raises(ValueError, match="K1 takes n <= 128"):
        K.pressure_cg_cuda(div, torch.zeros_like(div), planes, 1e-6, 10)
    assert K.pressure_cg_cuda.launches == before
    x, iters = K.pressure_cg(div, torch.zeros_like(div), planes, 1e-6, 10)
    torch.testing.assert_close(x, div / 4.0)  # A = 4 I converges in one step
    assert iters.tolist() == [1]


@pytest.mark.parametrize("n", [CELLS, 20])
def test_banded_stencil_equals_the_plain_stencil(masks, n):
    """Band edges, halo rows and the short last band: the banded stencil is
    bit for bit the plain one (the same products summed in the same order)."""
    _, tm = masks
    rng = np.random.default_rng(n)
    planes = tm.planes[:, :n, :n].contiguous()
    p = torch.from_numpy(rng.normal(size=(2, K.CHUNK, n, n)).astype(np.float32))
    rows = band_rows(K.cluster_layout(n), n)
    assert torch.equal(banded_stencil(planes, p, rows), K.apply_A_planes(planes, p))


def test_cluster_total_adds_every_rank_once():
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.normal(size=(4, 16)))  # float64: sums exact enough
    torch.testing.assert_close(cluster_total(parts, torch.add), parts.sum(-1), rtol=1e-12, atol=0)
    assert torch.equal(cluster_total(parts.abs(), torch.maximum), parts.abs().amax(-1))
    lay = K.cluster_layout(CELLS)
    t = torch.from_numpy(rng.normal(size=(1, K.CHUNK, CELLS, CELLS)))
    torch.testing.assert_close(block_partials(t, lay, lambda u: u.sum(-1)).sum(-1),
                               t.sum((1, 2, 3)), rtol=1e-12, atol=0)


@pytest.mark.parametrize("variant,check_every", [("v1", 1), ("v2", K.BLOCK_K)])
@pytest.mark.parametrize("b", [3, 10])
def test_banded_cg_matches_pallas(masks, variant, check_every, b):
    """The cluster kernel's arithmetic against the Pallas kernels, as
    test_torch_pressure_cg.py::test_plain_kernel_matches_pallas holds the
    plain version: warm start from a perturbed solution; b = 10 is two
    chunks, the second holding 2 samples."""
    jm, tm = masks
    div = np.random.default_rng(b).normal(size=(b, CELLS, CELLS)).astype(np.float32)
    rough = np.asarray(JS.pressure_solve(jm, jnp.asarray(div), 1e-3, 500))
    guess = (rough + 0.01 * np.random.default_rng(1).normal(size=div.shape)).astype(np.float32)
    ref = np.asarray(pressure_solve_pallas(jm, jnp.asarray(div), 1e-5, 500, interpret=True,
                                           guess=jnp.asarray(guess), variant=variant))
    out, iters = banded_cg(torch.from_numpy(div), torch.from_numpy(guess), tm.planes, 1e-5, 500,
                           check_every)
    assert iters.shape == (-(-b // K.CHUNK),)
    assert (iters > 0).all() and (iters % check_every == 0).all()
    # same recurrence, float32 sums in another order
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    plain, plain_iters = K.pressure_cg_plain(torch.from_numpy(div), torch.from_numpy(guess),
                                             tm.planes, 1e-5, 500, check_every)
    assert (iters - plain_iters).abs().max() <= max(check_every, 5)
