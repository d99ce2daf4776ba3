"""The precision policy (counterpart of ``bigdl_tpu.precision.policy``):
four dtypes that define a training or serving regime.

``param_dtype`` is what the weights are stored in at rest;
``compute_dtype`` is what the forward and backward matmuls run in (the
tensor cores' bfloat16); ``output_dtype`` is what the model hands the
loss; ``accum_dtype`` is where the reductions and the weight update
accumulate — pinned to float32 in every preset (norm statistics,
softmax, the loss and the master-copy update are the float32 islands).

The policy is declarative: ``build_train_step`` reads it once and does
the casts at the step's boundary, so switching ``f32`` to ``bf16_mixed``
is one ``Optimizer.set_precision`` call. When ``param_dtype`` is below
``accum_dtype`` the optimizer keeps a float32 master copy of the weights
in its state (``MASTER_KEY``): the update runs on the master and the
at-rest parameters are the master cast down.

Dtypes are ``torch.dtype``s here; :meth:`PrecisionPolicy.describe`
prints them with the JAX package's names (``bfloat16``, not
``torch.bfloat16``), so both packages log the same line.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bigdl_tpu_torch.utils.engine import to_torch_dtype

__all__ = ["MASTER_KEY", "PrecisionPolicy", "SCALER_KEY", "cast_floating",
           "dtype_name", "matmul_accum_dtype"]

# Reserved optimizer-state keys (the JAX package's strings, so a
# checkpoint of either package carries them under the same names): the
# loss-scaler state and the float32 master parameters ride the same
# optimizer state as the OptimMethod's buffers.
SCALER_KEY = "__bigdl_loss_scale__"
MASTER_KEY = "__bigdl_master_params__"

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def dtype_name(dtype: torch.dtype) -> str:
    """``"bfloat16"`` for ``torch.bfloat16``: the JAX package's name."""
    return str(dtype).split(".")[-1]


def cast_floating(tree, dtype):
    """Cast every floating tensor of ``tree`` (tensors in nested lists,
    tuples and dicts) to ``dtype``; integer and bool tensors (labels,
    segment ids, counters) and anything that is not a tensor pass
    through, and so does a tensor already in ``dtype`` (the same
    object)."""
    dtype = to_torch_dtype(dtype)
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.is_floating_point()
            and tree.dtype != dtype):
        return tree.to(dtype)
    return tree


def matmul_accum_dtype(operand_dtype) -> torch.dtype:
    """The accumulator dtype a matmul over ``operand_dtype`` operands
    asks for: float32 for bfloat16 and float16 (the tensor cores
    accumulate in float32; torch's low-precision matmuls do so and round
    once), the operand dtype otherwise."""
    dt = to_torch_dtype(operand_dtype)
    return torch.float32 if dt in _LOW_PRECISION else dt


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Declarative mixed-precision regime (the module docstring has the
    four dtypes).

    Presets: :meth:`f32` (everything float32, the no-op policy),
    :meth:`bf16_mixed` (float32 parameters, bfloat16 compute; bfloat16
    has float32's exponent range, so no loss scaling) and
    :meth:`f16_mixed` (float16 parameters at rest with a float32 master
    copy, float16 compute, dynamic loss scaling)."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    #: None = decide from compute_dtype (float16 scales)
    loss_scaling: Optional[bool] = None
    #: None = decide from param_dtype (below accum -> a float32 master).
    #: False trains directly on low-precision parameters: the
    #: pre-policy Engine behaviour ``from_engine`` keeps
    master_weights: Optional[bool] = None

    def __post_init__(self):
        for f in ("param_dtype", "compute_dtype", "output_dtype",
                  "accum_dtype"):
            object.__setattr__(self, f, to_torch_dtype(getattr(self, f)))
        if self.accum_dtype != torch.float32:
            raise ValueError(
                "accum_dtype must stay float32: reductions, norm stats "
                "and the master-copy update are the f32 islands that "
                "keep low-precision training convergent")

    # ---- presets ---------------------------------------------------------
    @classmethod
    def f32(cls) -> "PrecisionPolicy":
        """Everything float32: the pre-policy behaviour."""
        return cls()

    @classmethod
    def bf16_mixed(cls) -> "PrecisionPolicy":
        """float32 parameters at rest, bfloat16 forward and backward,
        float32 accumulation; no loss scaling."""
        return cls(compute_dtype=torch.bfloat16)

    @classmethod
    def f16_mixed(cls) -> "PrecisionPolicy":
        """float16 parameters at rest with a float32 master copy, float16
        compute, dynamic loss scaling (float16's 5 exponent bits
        underflow small gradients without it)."""
        return cls(param_dtype=torch.float16, compute_dtype=torch.float16,
                   loss_scaling=True)

    @classmethod
    def named(cls, name: str) -> "PrecisionPolicy":
        """Preset by name: ``"f32"`` | ``"bf16_mixed"`` | ``"f16_mixed"``."""
        try:
            return {"f32": cls.f32, "bf16_mixed": cls.bf16_mixed,
                    "f16_mixed": cls.f16_mixed}[name]()
        except KeyError:
            raise ValueError(
                f"unknown precision preset {name!r}; pick one of "
                "f32 | bf16_mixed | f16_mixed") from None

    @classmethod
    def from_engine(cls) -> "PrecisionPolicy":
        """The policy the Engine dtype knobs
        (:func:`~bigdl_tpu_torch.utils.engine.set_default_dtype`,
        :func:`~bigdl_tpu_torch.utils.engine.set_compute_dtype`) imply.
        That surface had no loss scaler and no master copy (a
        low-precision default dtype trains directly on low-precision
        parameters), so both are pinned off."""
        from bigdl_tpu_torch.utils import engine
        return cls(param_dtype=engine.default_dtype(),
                   compute_dtype=engine.compute_dtype(),
                   output_dtype=engine.default_dtype(),
                   loss_scaling=False, master_weights=False)

    # ---- derived properties ----------------------------------------------
    @property
    def is_noop(self) -> bool:
        """True when the policy changes nothing against plain float32
        training."""
        return (self.param_dtype == self.compute_dtype
                == self.output_dtype and not self.needs_loss_scaling
                and not self.needs_master)

    @property
    def needs_master(self) -> bool:
        """Parameters stored below accum precision: the optimizer keeps a
        float32 master copy (``MASTER_KEY``). An explicit
        ``master_weights`` wins."""
        if self.master_weights is not None:
            return self.master_weights
        return self.param_dtype != self.accum_dtype

    @property
    def needs_loss_scaling(self) -> bool:
        """An explicit ``loss_scaling`` wins; otherwise float16 compute
        scales."""
        if self.loss_scaling is not None:
            return self.loss_scaling
        return self.compute_dtype == torch.float16

    @property
    def name(self) -> str:
        """The preset name when this policy is one, else ``"custom"``."""
        for n in ("f32", "bf16_mixed", "f16_mixed"):
            if self == PrecisionPolicy.named(n):
                return n
        return "custom"

    # ---- casting ---------------------------------------------------------
    def cast_to_compute(self, tree):
        """Cast on entry: floating tensors to ``compute_dtype``."""
        return cast_floating(tree, self.compute_dtype)

    def cast_output(self, tree):
        """Cast on exit: floating tensors to ``output_dtype`` (what the
        loss takes)."""
        return cast_floating(tree, self.output_dtype)

    def cast_to_param(self, tree):
        """Floating tensors to ``param_dtype`` (the at-rest weights)."""
        return cast_floating(tree, self.param_dtype)

    def cast_to_accum(self, tree):
        """Floating tensors to ``accum_dtype`` (gradients entering the
        update)."""
        return cast_floating(tree, self.accum_dtype)

    def compute_parameters(self, module):
        """``{name: parameter cast to compute_dtype}`` over the module's
        ``named_parameters``: the dict :meth:`apply_module` hands
        ``torch.func.functional_call`` (casting is differentiable, so a
        float32 parameter's gradient arrives as the compute-dtype
        gradient cast up)."""
        return {name: self.cast_to_compute(p)
                for name, p in module.named_parameters()}

    def apply_module(self, module, x):
        """``module(x)`` under this policy: the floating parameters and
        ``x`` cast to ``compute_dtype`` for the call (through
        ``torch.func.functional_call``; the module itself is not changed
        and its buffers are not cast, as the JAX package never casts the
        model state), the output cast to ``output_dtype``. Layer-internal
        float32 islands (norm statistics, softmax) are the layers' own."""
        out = torch.func.functional_call(
            module, self.compute_parameters(module),
            (self.cast_to_compute(x),))
        return self.cast_output(out)

    def describe(self) -> str:
        """One line for logs, with the JAX package's dtype names."""
        return (f"{self.name}(param={dtype_name(self.param_dtype)}, "
                f"compute={dtype_name(self.compute_dtype)}, "
                f"output={dtype_name(self.output_dtype)}, "
                f"accum={dtype_name(self.accum_dtype)}, "
                f"loss_scaling={self.needs_loss_scaling})")
