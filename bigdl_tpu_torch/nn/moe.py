"""Mixture of Experts (counterpart of ``bigdl_tpu.nn.moe``).

The experts are one stacked weight per projection (``w_up [E, H, F]``,
``w_down [E, F, H]``), and routing is the JAX package's dense dispatch:
every expert computes every token and a one-hot combine weight zeroes
what was not routed, so the shapes are static (a CUDA-graph window
captures the step whole). The products are plain ``torch.einsum`` calls:
the JAX package leaves them to XLA, with no Pallas kernel.

The Switch-style load-balance term is the module's differentiable
``aux_term`` after a forward; right after its forward the train step
takes the sum of these terms and clears them (:func:`pop_aux_losses`),
and adds ``aux_loss_weight`` times the sum to the objective, so no
graph node outlives the step. Its float32 value and the top-1 routing
fractions are also kept in buffers under the JAX state tree's names
(``AUX_LOSS_KEY`` and ``expert_frac``), so state trees and checkpoints
carry them both ways.
Not ported: the expert-parallel sharding rules (ROADMAP queue 1, item
11).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["AUX_LOSS_KEY", "MoE", "pop_aux_losses"]

#: the JAX state tree's reserved name of an auxiliary loss leaf
AUX_LOSS_KEY = "__bigdl_aux_loss__"


class MoE(Module):
    """Top-k routed mixture of expert FFNs over ``[B, S, H]`` input.

    Parameters ``router [H, E]``, ``w_up [E, H, F]``, ``w_down [E, F,
    H]``, drawn uniform(-1/sqrt(H), 1/sqrt(H)) (``w_down``:
    1/sqrt(F)) from ``generator`` on the CPU (None: torch's global
    generator). A training forward writes the load-balance term's
    float32 value and ``expert_frac`` into the buffers (outside
    autograd); an evaluation forward leaves them."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 top_k: int = 2, activation: str = "gelu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.activation = activation
        dt = default_dtype()
        s_in = 1.0 / math.sqrt(hidden_size)
        s_ffn = 1.0 / math.sqrt(ffn_size)

        def uniform(shape, bound):
            return nn.Parameter(torch.empty(shape, dtype=dt).uniform_(
                -bound, bound, generator=generator))

        self.router = uniform((hidden_size, num_experts), s_in)
        self.w_up = uniform((num_experts, hidden_size, ffn_size), s_in)
        self.w_down = uniform((num_experts, ffn_size, hidden_size), s_ffn)
        self.register_buffer(AUX_LOSS_KEY,
                             torch.zeros((), dtype=torch.float32))
        self.register_buffer("expert_frac",
                             torch.zeros(num_experts, dtype=torch.float32))
        #: the differentiable load-balance term of the last forward,
        #: until :func:`pop_aux_losses` takes it
        self.aux_term: Optional[torch.Tensor] = None

    def forward(self, x):
        e = self.num_experts
        probs = torch.softmax(x @ self.router, dim=-1)          # [B,S,E]
        top_p, top_idx = torch.topk(probs, self.top_k, dim=-1)  # [B,S,K]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        combine = (F.one_hot(top_idx, e).to(x.dtype)
                   * top_p[..., None]).sum(dim=2)               # [B,S,E]
        h = torch.einsum("bsm,emf->ebsf", x, self.w_up)
        h = F.gelu(h, approximate="tanh") if self.activation == "gelu" \
            else torch.relu(h)
        y = torch.einsum("ebsf,efm->ebsm", h, self.w_down)
        out = torch.einsum("ebsm,bse->bsm", y, combine)
        # Switch load balance: E * sum_e (top-1 fraction) * (mean gate)
        frac = F.one_hot(top_idx[..., 0], e).float().mean(dim=(0, 1))
        aux = e * (frac * probs.mean(dim=(0, 1))).sum()
        self.aux_term = aux
        if self.training:
            with torch.no_grad():
                getattr(self, AUX_LOSS_KEY).copy_(aux.detach())
                self.expert_frac.copy_(frac)
        return out


def pop_aux_losses(module: torch.nn.Module):
    """The sum of the ``aux_term`` of every MoE in ``module``'s tree
    that has run a forward since the last call (a float32 0-d tensor,
    differentiable), or 0.0 where there is none; each term is cleared,
    so none joins a later objective and no graph node stays on the
    module (a deepcopy or pickle of it would refuse one)."""
    terms = []
    for m in module.modules():
        if isinstance(m, MoE) and m.aux_term is not None:
            terms.append(m.aux_term.float())
            m.aux_term = None
    if not terms:
        return 0.0
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total
