"""Precision (counterpart of ``bigdl_tpu.precision``): the training
policy and the dynamic loss scaler, and the int8 serving path's
calibration and accuracy gate.

- :class:`PrecisionPolicy` — the four dtypes of a regime
  (``param``/``compute``/``output``/``accum``), presets ``f32``,
  ``bf16_mixed`` and ``f16_mixed``; ``build_train_step`` casts at the
  step's boundary and ``Optimizer.set_precision`` keeps the float32
  master copy.
- :class:`DynamicLossScaler` — the float16 overflow state machine, its
  state on the device in the optimizer state, so
  ``set_steps_per_sync(K)`` windows carry it.
- :mod:`~bigdl_tpu_torch.precision.calibrate` and
  :class:`AccuracyGate` — int8 calibration and the serving gate.
"""
from bigdl_tpu_torch.precision.calibrate import (collect_activation_scales,
                                                 maybe_collect)
from bigdl_tpu_torch.precision.gate import AccuracyGate, AccuracyGateError
from bigdl_tpu_torch.precision.policy import (MASTER_KEY, SCALER_KEY,
                                              PrecisionPolicy, cast_floating,
                                              matmul_accum_dtype)
from bigdl_tpu_torch.precision.scaler import DynamicLossScaler

__all__ = ["AccuracyGate", "AccuracyGateError", "DynamicLossScaler",
           "MASTER_KEY", "PrecisionPolicy", "SCALER_KEY",
           "cast_floating", "collect_activation_scales",
           "matmul_accum_dtype", "maybe_collect"]
