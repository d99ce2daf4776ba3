"""Dynamic loss scaling for float16 training (counterpart of
``bigdl_tpu.precision.scaler``).

float16's 5 exponent bits underflow gradients around 6e-8, so the loss
is multiplied by a large scale before the backward and the gradients
divided back in float32 before the update. The scale adapts with the
classic overflow state machine:

- **non-finite gradients** (overflow): the step is skipped (parameters
  and optimizer buffers keep their previous values), the scale halves
  (``backoff_factor``) and the growth counter resets;
- **finite gradients**: the update applies; after ``growth_interval``
  finite steps in a row the scale doubles (``growth_factor``) and the
  counter resets.

The state ``{scale: float32, good_steps: int32, skipped: int32}`` is
made of 0-d tensors on the model's device and lives in the step's
optimizer state under ``precision.SCALER_KEY``. Every method here is
device arithmetic (``torch.where``, never ``.item()`` or a Python branch
on a tensor), so a windowed step captured into a CUDA graph carries the
machine: a window that overflows at step 3 backs off inside the graph
and step 4 retries at the halved scale, as the per-step loop does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

__all__ = ["DynamicLossScaler"]


@dataclasses.dataclass(frozen=True)
class DynamicLossScaler:
    """Configuration of the overflow state machine (module docstring);
    the mutable part is the state from :meth:`init_state`."""

    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 200
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def __post_init__(self):
        if not (self.growth_factor > 1.0 and 0.0 < self.backoff_factor
                < 1.0 and self.growth_interval >= 1
                and self.min_scale > 0.0):
            raise ValueError(
                "DynamicLossScaler needs growth_factor > 1, "
                "0 < backoff_factor < 1, growth_interval >= 1 and "
                "min_scale > 0")

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        """Fresh state on ``device``: ``{scale, good_steps, skipped}``."""
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.zeros((), dtype=torch.int32,
                                          device=device),
                "skipped": torch.zeros((), dtype=torch.int32,
                                       device=device)}

    @staticmethod
    def scale_loss(loss, state):
        """The loss actually differentiated: ``loss * scale`` (the scale
        cast to the loss's dtype)."""
        return loss * state["scale"].to(loss.dtype)

    @staticmethod
    def unscale(grads: Sequence[torch.Tensor], state):
        """Divide the scale back out; call after casting the gradients to
        the accum dtype, so the division is float32."""
        inv = 1.0 / state["scale"]
        return [g * inv.to(g.dtype) for g in grads]

    @staticmethod
    def all_finite(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """0-d bool tensor: every element of every floating gradient is
        finite (the skip-step probe)."""
        flags = [torch.isfinite(g).all() for g in grads
                 if g.is_floating_point()]
        if not flags:
            return torch.ones((), dtype=torch.bool)
        return torch.stack(flags).all()

    def next_state(self, state, finite) -> Dict[str, torch.Tensor]:
        """One transition (module docstring) given :meth:`all_finite`'s
        flag; returns new tensors, the state is not changed."""
        good = state["good_steps"] + 1
        grow = good >= self.growth_interval
        grown = torch.clamp(state["scale"] * self.growth_factor,
                            max=self.max_scale)
        backed = torch.clamp(state["scale"] * self.backoff_factor,
                             min=self.min_scale)
        scale = torch.where(finite, torch.where(grow, grown,
                                                state["scale"]), backed)
        good_steps = torch.where(finite, torch.where(grow, 0, good), 0)
        skipped = state["skipped"] + torch.where(finite, 0, 1)
        return {"scale": scale.to(torch.float32),
                "good_steps": good_steps.to(torch.int32),
                "skipped": skipped.to(torch.int32)}

    def advance(self, state, finite) -> None:
        """:meth:`next_state` written into ``state``'s tensors in place
        (what a captured step does: the graph reads and writes the same
        buffers every replay)."""
        new = self.next_state(state, finite)
        for k, t in new.items():
            state[k].copy_(t)
