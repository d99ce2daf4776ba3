"""Serving chassis of the port (counterpart of ``bigdl_tpu.serving``):
typed errors, the bucket ladder and program registry, and the model
registry the generation service builds on."""
from bigdl_tpu_torch.serving.compile_cache import BucketLadder, CompileCache
from bigdl_tpu_torch.serving.errors import (DeadlineExceeded, QueueFull,
                                            WorkerDied)
from bigdl_tpu_torch.serving.registry import ModelRegistry, Servable

__all__ = ["BucketLadder", "CompileCache", "DeadlineExceeded",
           "ModelRegistry", "QueueFull", "Servable", "WorkerDied"]
