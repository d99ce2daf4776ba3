"""Recovery from failures (counterpart of ``bigdl_tpu.faults``): the
classified retry policy (:mod:`bigdl_tpu_torch.faults.retry`) that the
optimizer's retry-from-checkpoint loop applies.

Not ported yet: the fault points and seeded fault schedules of
``bigdl_tpu.faults.core`` and its ``InjectedFault`` (ROADMAP queue 1,
item 12); an exception type the policy does not know is transient.
"""
from bigdl_tpu_torch.faults.retry import (FATAL_TYPES, TRANSIENT_TYPES,
                                          backoff_delay, classify,
                                          is_transient, retry_call)

__all__ = ["FATAL_TYPES", "TRANSIENT_TYPES", "backoff_delay", "classify",
           "is_transient", "retry_call"]
