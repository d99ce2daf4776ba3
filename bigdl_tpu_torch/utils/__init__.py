"""Device and dtype policy, host RNG, Table (counterpart of
``bigdl_tpu.utils``)."""
from bigdl_tpu_torch.utils.engine import (compute_dtype, default_dtype,
                                          full_float32, model_device,
                                          resolve_device, set_compute_dtype,
                                          set_default_dtype)
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["RandomGenerator", "T", "Table", "compute_dtype",
           "default_dtype", "full_float32", "model_device", "resolve_device",
           "set_compute_dtype", "set_default_dtype"]
