"""How the guidance gradient joins the predicted noise.

Port of `safediffcon_tpu/core/guidance.py`. The default combination is
additive (ep + nabla_J, reference: 1D/model/diffusion.py:292-294); the
reference also offers epsilon-orthogonal projections of the guidance
gradient (get_proj_ep_orthogonal_func, 1D/model/model_utils.py:71-88), for
three norms. A combination has the signature (ep, nabla_J) -> noise and is
handed to the samplers as `proj_guidance`.
"""
from __future__ import annotations

import torch


def additive(ep: torch.Tensor, nabla_j: torch.Tensor) -> torch.Tensor:
    """Default combination (reference: 1D/model/diffusion.py:292-294)."""
    return ep + nabla_j


def get_proj_ep_orthogonal(norm: str = "F"):
    """Remove from the guidance gradient its projection on epsilon before
    adding, in one of the reference's three norms
    (1D/model/model_utils.py:71-88): "F" over the last two axes with one
    coefficient over the whole tensor, "1D_x" along the last axis, "1D_t"
    along the second-last (the reference's 1D_t broadcasts only for an
    unbatched tensor; this keeps the time axis, so it is batched, as in the
    JAX package)."""
    if norm == "F":

        def proj(ep, nabla_j):
            coef = (nabla_j * ep).sum()
            denom = torch.sqrt((ep**2).sum(dim=(-2, -1)))[..., None, None]
            return ep + nabla_j - coef * ep / denom

    elif norm == "1D_x":

        def proj(ep, nabla_j):
            coef = (nabla_j * ep).sum(-1, keepdim=True)
            denom = torch.sqrt((ep**2).sum(-1, keepdim=True))
            return ep + nabla_j - coef * ep / denom

    elif norm == "1D_t":

        def proj(ep, nabla_j):
            coef = (nabla_j * ep).sum(-2, keepdim=True)
            denom = torch.sqrt((ep**2).sum(-2, keepdim=True))
            return ep + nabla_j - coef * ep / denom

    else:
        raise NotImplementedError(f"unknown norm {norm!r}")
    return proj
