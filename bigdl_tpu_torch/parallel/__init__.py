"""Distribution on ``torch.distributed``, one process a rank
(counterpart of ``bigdl_tpu.parallel``): the mesh, the collectives,
ZeRO's shard plan, and sequence parallelism (ring and Ulysses).
Tensor-parallel rules, expert parallelism and the pipeline are not
ported yet (ROADMAP queue 1, item 11)."""
from bigdl_tpu_torch.parallel.mesh import (Mesh, data_parallel_mesh,
                                           make_mesh, resolve_axis_mesh)
from bigdl_tpu_torch.parallel.ring_attention import (
    ring_attention, ring_attention_sharded)
from bigdl_tpu_torch.parallel.sequence import (
    SeqParallelConfig, active_sequence_parallel, record_degree,
    sequence_parallel_available, use_sequence_parallel)
from bigdl_tpu_torch.parallel.ulysses import (
    ulysses_attention, ulysses_attention_sharded)
from bigdl_tpu_torch.parallel.zero import (
    ZeroConfig, extend_spec, record_memory_gauges, shard_dim, shard_view,
    tree_bytes, tree_zero_specs)

__all__ = ["Mesh", "SeqParallelConfig", "ZeroConfig",
           "active_sequence_parallel", "data_parallel_mesh", "extend_spec",
           "make_mesh", "record_degree", "record_memory_gauges",
           "resolve_axis_mesh", "ring_attention", "ring_attention_sharded",
           "sequence_parallel_available", "shard_dim", "shard_view",
           "tree_bytes", "tree_zero_specs", "ulysses_attention",
           "ulysses_attention_sharded", "use_sequence_parallel"]
