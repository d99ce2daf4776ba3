"""Serving chassis of the port (counterpart of ``bigdl_tpu.serving``):
typed errors, the bucket ladder and program registry, the model
registry the generation service builds on, and the micro-batched
:class:`InferenceService` with its circuit breaker."""
from bigdl_tpu_torch.serving.batcher import MicroBatcher
from bigdl_tpu_torch.serving.breaker import CircuitBreaker, Degraded
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.serving.errors import (DeadlineExceeded, QueueFull,
                                            WorkerDied)
from bigdl_tpu_torch.serving.registry import ModelRegistry, Servable
from bigdl_tpu_torch.serving.service import InferenceService, ServingConfig

__all__ = ["BucketLadder", "CircuitBreaker", "CompileCache",
           "DeadlineExceeded", "Degraded", "InferenceService",
           "MicroBatcher", "ModelRegistry", "QueueFull", "Servable",
           "ServingConfig", "WorkerDied"]
