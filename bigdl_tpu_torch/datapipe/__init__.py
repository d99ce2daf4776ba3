"""The streaming data plane (counterpart of ``bigdl_tpu.datapipe``):
sharded streaming readers with serializable cursors (``readers``), the
seeded windowed shuffle (``shuffle``), sequence packing and length
bucketing (``packing``), staging to the card as batches or ``[K, B,
...]`` windows (``stage``), and the :class:`Pipeline` builder with
``as_dataset()``, a drop-in Optimizer DataSet whose cursor the
Optimizer checkpoints (docs/data.md: the determinism contract)."""
from bigdl_tpu_torch.datapipe.packing import (LengthBucketBatcher,
                                              SequencePacker, pack_documents,
                                              padding_efficiency)
from bigdl_tpu_torch.datapipe.pipeline import Pipeline
from bigdl_tpu_torch.datapipe.readers import (ArrayRecordReader,
                                              SeqFileImageReader,
                                              ShardedReader, TextLineReader)
from bigdl_tpu_torch.datapipe.shuffle import WindowShuffle
from bigdl_tpu_torch.datapipe.stage import stage_batches, stage_windows
from bigdl_tpu_torch.dataset.dataset import PipelineDataSet

__all__ = [
    "ShardedReader", "TextLineReader", "ArrayRecordReader",
    "SeqFileImageReader", "WindowShuffle", "SequencePacker",
    "LengthBucketBatcher", "pack_documents", "padding_efficiency",
    "stage_batches", "stage_windows", "Pipeline", "PipelineDataSet",
]
