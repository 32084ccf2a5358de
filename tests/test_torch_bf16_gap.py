"""The bf16 compute's distance from float32 on the same weights and draws,
the port's against the JAX package's, on the CPU: a guided Burgers DDIM
chain of the tiny UNet2D (the Burgers InfFT recipe's bf16 / float32 check
in small). float32 agrees between the two CPUs to rounding, so each side's
bf16-vs-float32 gap is its own bf16 path's."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from safediffcon_tpu.core import sampling as JSmp
from safediffcon_tpu.core import schedules as JS
from safediffcon_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from safediffcon_tpu.tasks.burgers import task as JK
from safediffcon_tpu.tasks.burgers.pipeline import build_model as jax_build_model
from safediffcon_torch.core import sampling as TSmp
from safediffcon_torch.core import schedules as TS
from safediffcon_torch.core.diffusion import DiffusionConfig
from safediffcon_torch.models.convert import flax_to_state_dict, state_dict_to_flax
from safediffcon_torch.tasks.burgers import task as TK
from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params

torch.set_num_threads(1)

SHAPE = (2, 16, 128, 3)
STEPS = 5  # DDIM steps of 100 timesteps, eta 1
TASK = dict(u_bound=0.8, w_score=500.0)  # the recipes' guidance
Q = 20.0


def _chains(guided: bool):
    """{(framework, dtype): the chain's sample} from one set of weights,
    conditions and draws."""
    net = init_params(build_model(16, (1, 2), device="cpu"), seed=0)
    params = state_dict_to_flax(net, net.state_dict())
    rng = np.random.default_rng(5)
    state = (0.3 * rng.normal(size=SHAPE)).astype(np.float32)
    init = rng.normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(6)
    k, steps = key, []
    for _ in range(STEPS - 1):
        k, sub = jax.random.split(k)
        steps.append(torch.from_numpy(np.array(jax.random.normal(sub, SHAPE, jnp.float32))))
    jcond = JK.BurgersConditioner(u0=jnp.asarray(state[:, 0, :, 0]),
                                  uT=jnp.asarray(state[:, 10, :, 0]))
    tcond = TK.BurgersConditioner(u0=torch.from_numpy(state[:, 0, :, 0]),
                                  uT=torch.from_numpy(state[:, 10, :, 0]))
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = jax_build_model(16, (1, 2), compute_dtype=dt)
        out["jax", dt] = np.asarray(JSmp.ddim_sample(
            jax.jit(jm.apply), params, JS.make_schedule(100, "cosine"),
            JDiffusionConfig(timesteps=100, sampling_timesteps=STEPS, ddim_eta=1.0), key, SHAPE,
            cond=jcond, init_noise=jnp.asarray(init),
            guidance_grad=JK.guidance_grad_fn(Q, JK.BurgersTaskConfig(**TASK)) if guided
            else None))
        tm = build_model(16, (1, 2), compute_dtype=None if dt == "float32" else dt,
                         device="cpu")
        tm.load_state_dict(flax_to_state_dict(tm, params))
        out["port", dt] = TSmp.sample(
            tm, TS.make_schedule(100, "cosine", device="cpu"),
            DiffusionConfig(timesteps=100, sampling_timesteps=STEPS, ddim_eta=1.0), SHAPE,
            cond=tcond, init_noise=torch.from_numpy(init), step_noise=steps,
            guidance_grad=TK.guidance_grad_fn(Q, TK.BurgersTaskConfig(**TASK)) if guided
            else None).detach().numpy()
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("guided", [True, False])
def test_bf16_gap_matches_jax(guided):
    out = _chains(guided)
    # float32: the same chain on both CPUs (measured 8.7e-6 guided, 1.5e-5
    # unguided, relative L2)
    assert _rel(out["port", "float32"], out["jax", "float32"]) < 1e-4
    gap_port = _rel(out["port", "bfloat16"], out["port", "float32"])
    gap_jax = _rel(out["jax", "bfloat16"], out["jax", "float32"])
    # each side's bf16 sample lies a few % from its float32 one (measured:
    # port 2.8 % / 3.4 %, JAX 4.5 % / 3.9 %, guided / unguided); the port's
    # gap is no larger than 1.5x JAX's, and the bf16 path does round (over
    # 1/4 of JAX's gap)
    assert 0.25 * gap_jax < gap_port < 1.5 * gap_jax, (gap_port, gap_jax)
