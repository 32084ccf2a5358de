"""KSTAR 0-D plasma surrogate solver in PyTorch.

Port of `safediffcon_tpu/solvers/kstar.py` (reference:
tokamak/kstar_solver.py:123-428, tokamak/common/model_structure.py). The
dense and LSTM surrogates are weight dicts applied by plain functions, and
every function is batched over a leading B: the port has no `vmap`, so one
rollout steps a whole batch of trajectories together (121 steps of Python
control flow, each a few hundred small launches on the card).

Numerical semantics, as in the JAX module:
  - only `best_model0` of each ensemble contributes (the reference resets
    every ensemble to n_model_box=1, kstar_solver.py:156-162);
  - the LSTM uses the TF2-default recurrent sigmoid (the runtime rebuilds
    the net via model_structure.py:67-79 with default activations, over the
    saved 'hard_sigmoid' config); its Keras layout has one bias and an
    (F, 4U) kernel, gates in the order i, f, c, o;
  - Keras batch norm at inference, eps 1e-3;
  - actuator values are quantized to 1e-3 via trunc(v * 1000) / 1000 in
    float32 (i2f/f2i, kstar_solver.py:111-117), the division taken as XLA
    takes it (`quantize`);
  - the rolling (10, 18) LSTM buffer shifts inputs before and states after
    each prediction (kstar_solver.py:229-258).

The LSTM cell is written with float32 `torch.matmul`, not `nn.LSTM`: on the
card the latter is cuDNN's RNN, which `torch.backends.cudnn.allow_tf32`
(True by default) lets run in TF32 through a recurrence of 121 x 20 cells.
Matmuls stay float32 as long as `torch.backends.cuda.matmul.allow_tf32` is
False, its default.

The weights are the port's own copy of the JAX package's archive
(`DEFAULT_WEIGHTS`, `tasks/tokamak/assets/kstar_weights.npz`, byte for byte
the same file); nothing of that package is imported or read.
"""
from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

DEFAULT_WEIGHTS = str(Path(__file__).resolve().parents[1] / "tasks" / "tokamak" / "assets"
                      / "kstar_weights.npz")

# --- physical constants of the reference setup (kstar_solver.py:49-105) ----
YEAR_IN = 2021.0
SEQ_LEN = 10
NT_ACTIONS = 121  # action steps; outputs have 122 rows
LOW_ACTION = np.array([0.3, 0.0, 0.0, 0.0, 1.6, 0.15, 0.5, 1.265, 2.14])
HIGH_ACTION = np.array([0.8, 1.75, 1.75, 1.5, 1.95, 0.5, 0.85, 1.36, 2.3])
LOW_TARGET = np.array([0.8, 4.0, 0.80])
HIGH_TARGET = np.array([2.1, 7.0, 1.05])
RAND_TARGET_MINS = np.array([1.06, 4.6, 0.85])
RAND_TARGET_MAXS = np.array([1.84, 6.4, 1.00])
TARGET_INIT = np.array([1.45, 5.5, 0.925])
LOOKBACK = 3
N_TARGETS = 4  # targets re-randomize every 30 steps: 0-30, 31-60, 61-90, 91-120

# input vector layout (input_params order, kstar_solver.py:78-86):
# 0 Ip, 1 Bt, 2 GW.frac, 3 Pnb1a, 4 Pnb1b, 5 Pnb1c, 6 Pec2, 7 Pec3,
# 8 Zec2, 9 Zec3, 10 In.Mid, 11 Out.Mid, 12 Elon, 13 Up.Tri, 14 Lo.Tri
INPUT_INIT = np.array(
    [0.5, 1.8, 0.33, 1.5, 1.5, 0.5, 0.0, 0.0, 0.0, 0.0, 1.32, 2.22, 1.7, 0.3, 0.75]
)
# action i writes input index ACTION_TO_INPUT[i] (kstar_solver.py:375)
ACTION_TO_INPUT = np.array([0, 3, 4, 5, 12, 13, 14, 10, 11])
# LSTM buffer columns 4..14 from the inputs (kstar_solver.py:210-227):
# Ip, Bt, GW, Elon, UpTri, LoTri, InMid, OutMid, Pnb1a, Pnb1b, Pnb1c
_LSTM_INPUT_COLS = [0, 1, 2, 12, 13, 14, 10, 11, 3, 4, 5]
# In.Mid above this (float32, as JAX compares it) sets the flag column
_IN_MID_FLAG = np.float32(1.265 + 1e-4)

# normalization constants (model_structure.py:85-88,100-106,141-142)
NN_YMEAN = np.array([1.22379703, 5.2361062, 1.64438005, 1.12040048])
NN_YSTD = np.array([0.72255576, 1.5622809, 0.96563557, 0.23868018])
LSTM_YMEAN = np.array([1.4361666, 5.275876, 1.534538, 1.1268075])
LSTM_YSTD = np.array([0.7294007, 1.5010427, 0.6472052, 0.2331879])
BPW_YMEAN = np.array([1.02158800e00, 1.87408512e05])
BPW_YSTD = np.array([6.43390272e-01, 1.22543529e05])

_INPUT_INIT_Q = np.trunc(INPUT_INIT * 1000.0) / 1000.0


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The constants and index vectors the step functions use, copied to
    `device` once: a copy from host memory inside the 121-step loop would
    make the host wait for the card at every step, and cannot be part of a
    captured CUDA graph (an evaluate's rollout; its first, eager call fills
    this cache)."""
    low_state = np.concatenate([np.concatenate([LOW_ACTION, LOW_TARGET])] * LOOKBACK
                               + [LOW_TARGET])
    high_state = np.concatenate([np.concatenate([HIGH_ACTION, HIGH_TARGET])] * LOOKBACK
                                + [HIGH_TARGET])
    out = {name: _f32(value, device) for name, value in dict(
        low_action=LOW_ACTION, high_action=HIGH_ACTION, low_state=low_state,
        high_state=high_state, target_lo=RAND_TARGET_MINS, target_hi=RAND_TARGET_MAXS,
        hist0=np.concatenate([LOW_ACTION, TARGET_INIT]), input_init=_INPUT_INIT_Q[None],
        nn_ystd=NN_YSTD, nn_ymean=NN_YMEAN,
        lstm_ystd=LSTM_YSTD, lstm_ymean=LSTM_YMEAN, bpw_ystd=BPW_YSTD,
        bpw_ymean=BPW_YMEAN).items()}
    for name, idx in dict(action_to_input=ACTION_TO_INPUT, lstm_input_cols=_LSTM_INPUT_COLS,
                          history_outputs=[1, 4, 6]).items():
        out[name] = torch.as_tensor(idx, dtype=torch.long, device=device)
    return out


# XLA rewrites the JAX module's trunc(v * 1000) / 1000 into a product with
# the float32 reciprocal of 1000, which rounds differently from the division
# in about half the cases (by one ulp); the port computes that product
_MILLI = float(np.float32(1e-3))


def quantize(v: torch.Tensor) -> torch.Tensor:
    """i2f(f2i(v)): truncate toward zero at 1e-3 in float32
    (kstar_solver.py:111-117), as the JAX package computes it."""
    return torch.trunc(v * 1000.0) * _MILLI


def load_kstar_params(path: str = DEFAULT_WEIGHTS, device="cuda") -> Dict:
    """The converted weight archive as nested dicts of float32 tensors on
    `device` ("rl"/"n_layers" as an int)."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            value = flat[key]
            node[leaf] = int(value) if value.dtype.kind == "i" else _f32(value, device)
    return tree


# ---------------------------------------------------------------------------
# Network forward functions, batched over the leading axes
# ---------------------------------------------------------------------------

def _bn(w, x):
    # Keras BatchNormalization inference transform, eps 1e-3
    return (x - w["mean"]) / torch.sqrt(w["var"] + 1e-3) * w["gamma"] + w["beta"]


def _dense(w, x):
    return x @ w["kernel"] + w["bias"]


def mlp_forward(w: Dict, x: torch.Tensor, n_dense: int) -> torch.Tensor:
    """BN -> [Dense sigmoid -> BN] x (n-1) -> Dense linear
    (kstar_nn / bpw_nn / k2rz topology, model_structure.py + saved configs)."""
    h = _bn(w["bn0"], x)
    for i in range(n_dense - 1):
        h = torch.sigmoid(_dense(w[f"dense{i}"], h))
        h = _bn(w[f"bn{i + 1}"], h)
    return _dense(w[f"dense{n_dense - 1}"], h)


def lstm_layer(w: Dict, xs: torch.Tensor) -> torch.Tensor:
    """One Keras-layout LSTM over xs (B, T, F) from zero state; returns the
    (B, T, U) sequence of h. z = x K + h R + b, gates i, f, c, o along the 4U
    axis; activation tanh, recurrent sigmoid. The input projection of all T
    steps is one matmul."""
    units = w["recurrent"].shape[0]
    xk = xs @ w["kernel"]  # (B, T, 4U)
    h = xs.new_zeros((xs.shape[0], units))
    c = torch.zeros_like(h)
    hs = []
    for step in range(xs.shape[1]):
        z = xk[:, step] + h @ w["recurrent"] + w["bias"]
        gates = torch.sigmoid(z)
        i, f, o = gates[:, :units], gates[:, units : 2 * units], gates[:, 3 * units :]
        c = f * c + i * torch.tanh(z[:, 2 * units : 3 * units])
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def lstm_forward(w: Dict, x_seq: torch.Tensor) -> torch.Tensor:
    """kstar_v220505 forward on (B, SEQ_LEN, 18) buffers -> (B, 4) raw output.

    BN -> LSTM(100, seq) -> BN -> LSTM(100, last) -> BN -> Dense(50, sigmoid)
    -> BN -> Dense(4) (model_structure.py:67-79 with [100,100],[50,4])."""
    h = _bn(w["bn0"], x_seq)
    h = lstm_layer(w["lstm0"], h)
    h = _bn(w["bn1"], h)
    h = lstm_layer(w["lstm1"], h)[:, -1]
    h = _bn(w["bn2"], h)
    h = torch.sigmoid(_dense(w["dense0"], h))
    h = _bn(w["bn3"], h)
    return _dense(w["dense1"], h)


def rl_policy_forward(w: Dict, obs: torch.Tensor) -> torch.Tensor:
    """SB2 MLP policy on (B, 39) observations: normalize, relu fc stack, tanh
    head, denormalize to the action bounds (model_structure.py:178-204 with
    bavg=0). Returns (B, 9)."""
    c = _consts(obs.device)
    h = 2.0 * (obs - c["low_state"]) / (c["high_state"] - c["low_state"]) - 1.0
    for i in range(w["n_layers"]):
        h = torch.relu(_dense(w[f"fc{i}"], h))
    y = torch.tanh(_dense(w["out"], h))
    low, high = c["low_action"], c["high_action"]
    return 0.5 * (high - low) * (y + 1.0) + low


# ---------------------------------------------------------------------------
# Solver stepping
# ---------------------------------------------------------------------------

class SolverState(NamedTuple):
    buffer: torch.Tensor  # (B, SEQ_LEN, 18) LSTM rolling buffer
    inputs: torch.Tensor  # (B, 15) quantized actuator vector
    outputs: torch.Tensor  # (B, 8) last [βn, βp, h89, h98, q95, q0, li, wmhd]


def _lstm_input_row(inputs: torch.Tensor) -> torch.Tensor:
    """Columns 4..17 of the LSTM buffer from the (B, 15) actuator vectors
    (kstar_solver.py:210-227): [Ip, Bt, GW, Elon, UpTri, LoTri, InMid,
    OutMid, Pnb1a, Pnb1b, Pnb1c, Pec2+Pec3, InMid>1.265, year]."""
    flag = (inputs[:, 10] > float(_IN_MID_FLAG)).to(inputs.dtype)
    return torch.cat([
        inputs.index_select(1, _consts(inputs.device)["lstm_input_cols"]),
        (inputs[:, 6] + inputs[:, 7])[:, None],
        flag[:, None],
        torch.full_like(flag[:, None], YEAR_IN),
    ], dim=1)


def _bpw_and_h(params, inputs, bn):
    """βp / wmhd prediction and the h89 / h98 estimates, each (B,)
    (kstar_solver.py:268-346)."""
    rgeo = 0.5 * (inputs[:, 10] + inputs[:, 11])
    amin = 0.5 * (inputs[:, 11] - inputs[:, 10])
    x = torch.stack([bn, inputs[:, 0], inputs[:, 1], rgeo, amin, inputs[:, 12], inputs[:, 13],
                     inputs[:, 14]], dim=1)
    c = _consts(x.device)
    y = mlp_forward(params["bpw"], x, 3) * c["bpw_ystd"] + c["bpw_ymean"]
    beta_p, wmhd = y[:, 0], y[:, 1]

    ip, bt, fgw = inputs[:, 0], inputs[:, 1], inputs[:, 2]
    ptot = torch.clamp_min(
        inputs[:, 3] + inputs[:, 4] + inputs[:, 5] + inputs[:, 6] + inputs[:, 7], 1e-1)
    k = inputs[:, 12]
    ne = fgw * 10.0 * (ip / (np.pi * amin**2))
    m = 2.0
    tau89 = (
        0.038 * ip**0.85 * bt**0.2 * ne**0.1 * ptot**-0.5
        * rgeo**1.5 * k**0.5 * (amin / rgeo) ** 0.3 * m**0.5
    )
    tau98 = (
        0.0562 * ip**0.93 * bt**0.15 * ne**0.41 * ptot**-0.69
        * rgeo**1.97 * k**0.78 * (amin / rgeo) ** 0.58 * m**0.19
    )
    h89 = 1e-6 * wmhd / ptot / tau89
    h98 = 1e-6 * wmhd / ptot / tau98
    return beta_p, wmhd, h89, h98


def steady_init(params: Dict, batch: int = 1) -> SolverState:
    """First solver step from the fixed initial actuators via the dense
    surrogate (kstar_solver.py:174-227,389-400), for `batch` trajectories
    (all equal)."""
    device = params["nn"]["bn0"]["mean"].device
    c = _consts(device)
    inputs = c["input_init"]
    rgeo = 0.5 * (inputs[:, 10] + inputs[:, 11])
    amin = 0.5 * (inputs[:, 11] - inputs[:, 10])
    flag = (inputs[:, 10] > float(_IN_MID_FLAG)).to(inputs.dtype)
    x = torch.cat([
        inputs[:, :2],  # Ip, Bt
        inputs[:, 3:10],  # Pnb1a..Zec3
        torch.stack([rgeo, amin], dim=1),
        inputs[:, 12:15],  # Elon, UpTri, LoTri
        torch.stack([flag, inputs[:, 2], torch.full_like(flag, YEAR_IN)], dim=1),
    ], dim=1)
    y = mlp_forward(params["nn"], x, 4) * c["nn_ystd"] + c["nn_ymean"]
    bn_, q95, q0, li = y.unbind(1)

    row = _lstm_input_row(inputs)
    buffer = torch.cat([y[:, None].expand(1, SEQ_LEN, 4), row[:, None].expand(1, SEQ_LEN, 14)],
                       dim=2)
    beta_p, wmhd, h89, h98 = _bpw_and_h(params, inputs, bn_)
    outputs = torch.stack([bn_, beta_p, h89, h98, q95, q0, li, wmhd], dim=1)
    return SolverState(buffer=buffer.expand(batch, -1, -1), inputs=inputs.expand(batch, -1),
                       outputs=outputs.expand(batch, -1))


def apply_action(state: SolverState, action: torch.Tensor) -> SolverState:
    """Clip + quantize the (B, 9) actuator commands into the input vectors
    (kstar_solver.py:360-380)."""
    c = _consts(action.device)
    a = quantize(torch.clamp(action, c["low_action"], c["high_action"]))
    inputs = state.inputs.index_copy(1, c["action_to_input"], a)
    return state._replace(inputs=inputs)


def lstm_step(params: Dict, state: SolverState) -> SolverState:
    """One non-steady solver step (kstar_solver.py:229-267): shift the input
    columns up and write the new actuators into the last row, predict, then
    shift the state columns and write the prediction."""
    buf = state.buffer
    row = _lstm_input_row(state.inputs)
    inputs_cols = torch.cat([buf[:, 1:, 4:], row[:, None]], dim=1)
    c = _consts(buf.device)
    y = (lstm_forward(params["lstm"], torch.cat([buf[:, :, :4], inputs_cols], dim=2))
         * c["lstm_ystd"] + c["lstm_ymean"])
    state_cols = torch.cat([buf[:, 1:, :4], y[:, None]], dim=1)

    bn_, q95, q0, li = y.unbind(1)
    beta_p, wmhd, h89, h98 = _bpw_and_h(params, state.inputs, bn_)
    outputs = torch.stack([bn_, beta_p, h89, h98, q95, q0, li, wmhd], dim=1)
    return SolverState(buffer=torch.cat([state_cols, inputs_cols], dim=2), inputs=state.inputs,
                       outputs=outputs)


@torch.no_grad()
def simulate_batch(params: Dict, actions: torch.Tensor) -> torch.Tensor:
    """(B, 121, 9) action sequences -> (B, 122, 8) outputs
    ([βn, βp, h89, h98, q95, q0, li, wmhd] per step, kstar_solver.py:389-428)."""
    state = steady_init(params, actions.shape[0])
    outs = [state.outputs]
    for step in range(actions.shape[1]):
        state = lstm_step(params, apply_action(state, actions[:, step]))
        outs.append(state.outputs)
    return torch.stack(outs, dim=1)


def simulate(params: Dict, actions: torch.Tensor) -> torch.Tensor:
    """One action sequence (121, 9) -> outputs (122, 8)."""
    return simulate_batch(params, actions[None])[0]


# ---------------------------------------------------------------------------
# Closed-loop data generation (RL policy in the loop)
# ---------------------------------------------------------------------------

def targets_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """(..., N_TARGETS, 3) uniforms in [0, 1) -> the quantized random
    targets (reference: kstar_data_generator_random_target.py:433-520)."""
    c = _consts(u.device)
    return quantize(u * (c["target_hi"] - c["target_lo"]) + c["target_lo"])


def draw_targets(n: int, generator: Optional[torch.Generator] = None,
                 device="cuda") -> torch.Tensor:
    """(n, N_TARGETS, 3) random targets from `generator`."""
    u = torch.rand((n, N_TARGETS, 3), generator=generator, device=device)
    return targets_from_uniform(u)


@torch.no_grad()
def closed_loop_from_targets(
    params: Dict, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-loop trajectories of the RL policy and the surrogate toward
    the (B, N_TARGETS, 3) targets, which change every 30 steps (reference:
    tokamak/kstar_data_generator_random_target.py:433-520).

    Returns (outputs (B, 122, 8), actions (B, 121, 9), targets (B, 122, 3)).
    The policy observes LOOKBACK rows of [action (9), βp, q95, li] plus the
    current target."""
    b, c = targets.shape[0], _consts(targets.device)
    state = steady_init(params, b)
    hist = c["hist0"].expand(b, LOOKBACK, 12)
    outs, actions, tgts = [state.outputs], [], []
    for step in range(NT_ACTIONS):
        # step 0 and steps 1-30 take target 0, then one target per 30 steps
        target = targets[:, min(max(step - 1, 0) // 30, N_TARGETS - 1)]
        action = rl_policy_forward(params["rl"], torch.cat([hist.reshape(b, -1), target], 1))
        state = lstm_step(params, apply_action(state, action))
        # history rows: [action(9), βp, q95, li] (kstar_solver.py:311-316)
        new_row = torch.cat([action, state.outputs.index_select(1, c["history_outputs"])],
                            dim=1)
        hist = torch.cat([hist[:, 1:], new_row[:, None]], dim=1)
        outs.append(state.outputs)
        actions.append(action)
        tgts.append(target)
    tgts = [tgts[0]] + tgts
    return torch.stack(outs, 1), torch.stack(actions, 1), torch.stack(tgts, 1)


def closed_loop_batch(params: Dict, n: int, generator: Optional[torch.Generator] = None):
    """n closed-loop trajectories with targets drawn from `generator`
    (replaces the reference's ThreadPool-of-subprocesses data generator,
    tokamak/data_parallel_generate.py:17-33)."""
    device = params["rl"]["out"]["kernel"].device
    return closed_loop_from_targets(params, draw_targets(n, generator, device))


def closed_loop_rollout(params: Dict, generator: Optional[torch.Generator] = None):
    """One closed-loop trajectory: (outputs (122, 8), actions (121, 9),
    targets (122, 3))."""
    return tuple(a[0] for a in closed_loop_batch(params, 1, generator))


# ---------------------------------------------------------------------------
# Plasma boundary shape predictor (visualization utility)
# ---------------------------------------------------------------------------

@torch.no_grad()
def k2rz_forward(params: Dict, ip, bt, betap, rin, rout, k, du, dl,
                 n_theta: int = 64, xpt_correction: bool = True,
                 closed_surface: bool = True):
    """Plasma boundary (R, Z) contour from 0-D parameters
    (reference: tokamak/common/model_structure.py:5-38, k2rz model0).

    Returns numpy arrays (rbdry, zbdry); the x-point correction moves the
    extremal contour points exactly as the reference post-processing does.
    """
    device = params["k2rz"]["bn0"]["mean"].device
    x = torch.tensor([ip, bt, betap, rin, rout, k, du, dl], dtype=torch.float32, device=device)
    y = mlp_forward(params["k2rz"], x, 4).cpu().numpy()
    rbdry, zbdry = y[:n_theta].copy(), y[n_theta:].copy()
    if xpt_correction:
        rgeo = 0.5 * (rbdry.max() + rbdry.min())
        amin = 0.5 * (rbdry.max() - rbdry.min())
        if du <= dl:
            rx = rgeo - amin * dl
            zx = zbdry.max() - 2.0 * k * amin
            rx2 = rgeo - amin * du
            rbdry[np.argmin(zbdry)] = rx
            zbdry[np.argmin(zbdry)] = zx
            rbdry[np.argmax(zbdry)] = rx2
        else:
            rx = rgeo - amin * du
            zx = zbdry.min() + 2.0 * k * amin
            rx2 = rgeo - amin * dl
            rbdry[np.argmax(zbdry)] = rx
            zbdry[np.argmax(zbdry)] = zx
            rbdry[np.argmin(zbdry)] = rx2
    if closed_surface:
        rbdry = np.append(rbdry, rbdry[0])
        zbdry = np.append(zbdry, zbdry[0])
    return rbdry, zbdry
