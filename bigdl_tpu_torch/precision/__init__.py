"""Int8 calibration and the accuracy gate (the slice of
``bigdl_tpu.precision`` the int8 serving path needs; precision
policies and loss scaling are not ported yet)."""
from bigdl_tpu_torch.precision.calibrate import (collect_activation_scales,
                                                 maybe_collect)
from bigdl_tpu_torch.precision.gate import AccuracyGate, AccuracyGateError

__all__ = ["AccuracyGate", "AccuracyGateError", "collect_activation_scales",
           "maybe_collect"]
