"""Classified retry with exponential backoff and jitter (counterpart of
``bigdl_tpu.faults.retry``).

- :func:`classify` splits exceptions into **fatal** (structural: wrong
  types, missing attributes, shape mismatches; a retry replays the same
  failure, so fail fast with the first diagnostic) and **transient**
  (IO, runtime errors such as a CUDA error, unknown types: retry);
- :func:`backoff_delay` doubles a base interval per attempt up to a
  cap, with equal jitter so retriers that failed together spread out;
- :func:`retry_call` wraps one callable with both, counting every retry
  in the ``io/retry/retries`` counter.

``Optimizer.optimize`` applies the same policy to a whole run, from the
newest checkpoint.
"""
from __future__ import annotations

import logging
import random
import time
from typing import Callable, Optional, Tuple

from bigdl_tpu_torch import telemetry

__all__ = ["FATAL_TYPES", "TRANSIENT_TYPES", "backoff_delay", "classify",
           "is_transient", "retry_call"]

logger = logging.getLogger(__name__)

_RETRIES = telemetry.counter(
    "io/retry/retries",
    "transient-failure retries performed by retry_call")

# the jitter's source when a caller passes no seeded rng: a private
# instance, never the global stdlib stream
_JITTER_RNG = random.Random()

#: structural errors: a retry replays the same failure. Checked before
#: the transient types, since ``NotImplementedError`` is a
#: ``RuntimeError``.
FATAL_TYPES: Tuple[type, ...] = (
    TypeError, ValueError, KeyError, IndexError, AttributeError,
    NotImplementedError, ImportError, SyntaxError, MemoryError,
)

#: errors of the environment, worth a retry: IO and connections, and
#: runtime failures (a CUDA error is a ``RuntimeError``).
TRANSIENT_TYPES: Tuple[type, ...] = (
    OSError, ConnectionError, TimeoutError, RuntimeError,
)


def classify(exc: BaseException) -> str:
    """``"fatal"`` or ``"transient"`` for one exception.

    An exception carrying ``bigdl_fatal = True`` (``CheckpointCorrupt``,
    which escapes a resume only when its quarantine failed) is fatal
    whatever its base class; then the fatal types win over the
    transient ones; an unknown type is transient (a retry that raises
    again says more than failing fast on a passing blip)."""
    if getattr(exc, "bigdl_fatal", False):
        return "fatal"
    if isinstance(exc, FATAL_TYPES):
        return "fatal"
    return "transient"


def is_transient(exc: BaseException) -> bool:
    """True when :func:`classify` calls the exception retryable."""
    return classify(exc) == "transient"


def backoff_delay(attempt: int, base_s: float, max_s: float = 30.0,
                  rng: Optional[random.Random] = None) -> float:
    """Seconds to sleep before retry number ``attempt`` (0-based):
    ``d = min(base * 2 ** attempt, max_s)``, equal-jittered into
    ``[d / 2, d)``. A seeded ``rng`` gives a reproducible schedule."""
    d = min(float(base_s) * (2.0 ** attempt), float(max_s))
    r = (rng if rng is not None else _JITTER_RNG).random()
    return d / 2.0 + d / 2.0 * r


def retry_call(fn: Callable, *args, attempts: int = 3,
               base_delay_s: float = 0.5, max_delay_s: float = 30.0,
               rng: Optional[random.Random] = None,
               describe: str = "", sleep: Callable[[float], None]
               = time.sleep, **kwargs):
    """``fn(*args, **kwargs)``, retrying transient failures up to
    ``attempts`` tries in all with :func:`backoff_delay` sleeps between
    them. A fatal failure and the last transient one raise unchanged.
    Each retry adds one to ``io/retry/retries`` and logs a warning
    naming ``describe`` (default: the callable's name)."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    what = describe or getattr(fn, "__name__", "call")
    for attempt in range(attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if classify(e) == "fatal" or attempt == attempts - 1:
                raise
            delay = backoff_delay(attempt, base_delay_s, max_delay_s, rng)
            _RETRIES.inc()
            logger.warning(
                "%s failed (%s: %s); retry %d/%d in %.2fs", what,
                type(e).__name__, e, attempt + 1, attempts - 1, delay)
            sleep(delay)
