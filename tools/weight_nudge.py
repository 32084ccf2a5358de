"""Half a bf16 step of seeded noise on a model's weights, the perturbation
the spread tools (`burgers_sampler_swap.py`, `tokamak_pretrain_spread.py`,
`burgers_dpm_grid.py`) measure against: every floating weight w becomes
w + 2^-9 |w| N(0, 1), drawn on the CPU in the state_dict's order."""
import torch


def nudged(params: dict, seed: int = 0) -> dict:
    """`params` (a state_dict, on any device) with every floating weight
    nudged from a generator seeded with `seed`; other entries as they are."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in params.items():
        if v.is_floating_point():
            c = v.detach().float().cpu()
            v = (c + 2.0**-9 * c.abs() * torch.randn(c.shape, generator=gen)).to(v)
        out[k] = v
    return out
