"""Token data layouts (counterpart of ``bigdl_tpu.datapipe``): packing
of documents into fixed-width slabs, and the streaming packing and
length-bucketing stages."""
from bigdl_tpu_torch.datapipe.packing import (LengthBucketBatcher,
                                              SequencePacker, pack_documents,
                                              padding_efficiency)

__all__ = ["LengthBucketBatcher", "SequencePacker", "pack_documents",
           "padding_efficiency"]
