"""Token data layouts (counterpart of ``bigdl_tpu.datapipe``): packing
and padding of documents into fixed-width slabs."""
from bigdl_tpu_torch.datapipe.packing import (pack_documents, pad_documents,
                                              padding_efficiency)

__all__ = ["pack_documents", "pad_documents", "padding_efficiency"]
