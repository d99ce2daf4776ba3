"""Deterministic fault injection and recovery (counterpart of
``bigdl_tpu.faults``).

Named fault points sit where real systems die (mid-checkpoint-write, on
the serving dispatch thread, inside a decode step, at the fleet's
routing edge), and a seeded :class:`FaultSchedule` scripts what each one
does (:mod:`bigdl_tpu_torch.faults.core`); disarmed, a point is one flag
check. The recovery half is the classified retry policy
(:mod:`bigdl_tpu_torch.faults.retry`) that the optimizer's
retry-from-checkpoint loop applies::

    from bigdl_tpu_torch import faults

    faults.point("serving/decode", model=name)       # in library code

    with faults.armed("train/step=nth:6,raise:OSError"):
        optimizer.optimize()                          # retries, resumes
"""
from bigdl_tpu_torch.faults.core import (KNOWN_POINTS, NAMED_EXCEPTIONS,
                                         FaultRule, FaultSchedule,
                                         InjectedFault, active_schedule,
                                         arm, armed, disarm, injected_total,
                                         is_armed, parse_schedule, point)
from bigdl_tpu_torch.faults.retry import (FATAL_TYPES, TRANSIENT_TYPES,
                                          backoff_delay, classify,
                                          is_transient, retry_call)

__all__ = [
    "FaultRule", "FaultSchedule", "InjectedFault", "KNOWN_POINTS",
    "NAMED_EXCEPTIONS",
    "active_schedule", "arm", "armed", "disarm", "injected_total",
    "is_armed", "parse_schedule", "point",
    "FATAL_TYPES", "TRANSIENT_TYPES", "backoff_delay", "classify",
    "is_transient", "retry_call",
]
