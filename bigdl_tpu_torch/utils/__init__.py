"""Device and dtype policy, host RNG (counterpart of
``bigdl_tpu.utils``)."""
from bigdl_tpu_torch.utils.engine import (default_dtype, full_float32,
                                          model_device, resolve_device)
from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["RandomGenerator", "default_dtype", "full_float32",
           "model_device", "resolve_device"]
