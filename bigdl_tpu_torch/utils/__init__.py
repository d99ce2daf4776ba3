"""Device and dtype policy (counterpart of ``bigdl_tpu.utils``)."""
from bigdl_tpu_torch.utils.engine import default_dtype, resolve_device

__all__ = ["default_dtype", "resolve_device"]
