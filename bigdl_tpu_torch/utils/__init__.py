"""Device and dtype policy, host RNG, Table (counterpart of
``bigdl_tpu.utils``)."""
from bigdl_tpu_torch.utils.engine import (default_dtype, full_float32,
                                          model_device, resolve_device)
from bigdl_tpu_torch.utils.random import RandomGenerator
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["RandomGenerator", "T", "Table", "default_dtype", "full_float32",
           "model_device", "resolve_device"]
