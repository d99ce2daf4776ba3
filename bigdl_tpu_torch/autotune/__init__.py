"""Tuned configurations (counterpart of ``bigdl_tpu.autotune``): the
fingerprinted ``tuned.json`` artifact the serving facade applies
(:func:`~bigdl_tpu_torch.generation.service.apply_tuned_config`)."""
from bigdl_tpu_torch.autotune.config import (TUNED_SCHEMA_VERSION,
                                             Fingerprint,
                                             FingerprintMismatchError,
                                             TunedConfig, TunedConfigError,
                                             apply_tuned_optimizer,
                                             load_tuned, save_tuned)

__all__ = ["TUNED_SCHEMA_VERSION", "Fingerprint", "FingerprintMismatchError",
           "TunedConfig", "TunedConfigError", "apply_tuned_optimizer",
           "load_tuned", "save_tuned"]
