"""Generation serving of the port (counterpart of
``bigdl_tpu.generation``): bucketed KV-cache decode with continuous
batching, on the card by default; prefix/KV reuse and speculative
decoding sit in :mod:`bigdl_tpu_torch.fleet`."""
from bigdl_tpu_torch.generation.engine import DecodeEngine
from bigdl_tpu_torch.generation.kv_cache import KVCache, SlotAllocator
from bigdl_tpu_torch.generation.loop import DecodeLoop
from bigdl_tpu_torch.generation.sampling import Sampler, SamplingParams
from bigdl_tpu_torch.generation.service import (GenerationConfig,
                                                GenerationService,
                                                apply_tuned_config)
from bigdl_tpu_torch.generation.stream import TokenStream

__all__ = ["DecodeEngine", "DecodeLoop", "GenerationConfig",
           "GenerationService", "KVCache", "Sampler", "SamplingParams",
           "SlotAllocator", "TokenStream", "apply_tuned_config"]
