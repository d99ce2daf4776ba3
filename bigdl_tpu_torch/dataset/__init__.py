"""Datasets, samples and batching (counterpart of
``bigdl_tpu.dataset``): in-memory and sharded datasets, the image
transformers and the threaded ImageNet feed from a folder, record
shards or SequenceFiles, the copy to the card, and the text readers."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet, PipelineDataSet,
                                             ShardedDataSet,
                                             TransformedDataSet,
                                             array_to_samples)
from bigdl_tpu_torch.dataset.image import load_mnist
from bigdl_tpu_torch.dataset.imagenet import (IMAGENET_MEAN, IMAGENET_STD,
                                              ImageFolderDataSet,
                                              ImageRecordWriter,
                                              decode_image,
                                              list_image_folder,
                                              read_image_records,
                                              write_image_record_shards)
from bigdl_tpu_torch.dataset.prefetch import (batch_signature,
                                              device_prefetch,
                                              stack_minibatches,
                                              stack_windows)
from bigdl_tpu_torch.dataset.sample import (HostBatchedCOO, MiniBatch,
                                            PaddingParam, Sample,
                                            SparseFeature,
                                            minibatch_input_to_device,
                                            samples_to_minibatch)
from bigdl_tpu_torch.dataset.seqfile import (SequenceFileWriter,
                                             read_seq_image_records,
                                             read_sequence_file,
                                             write_seq_image_shards)
from bigdl_tpu_torch.dataset.text import (Dictionary, load_ptb, ptb_arrays,
                                          read_words, tokenize)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer, Lambda,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet", "Dictionary",
           "HostBatchedCOO", "IMAGENET_MEAN", "IMAGENET_STD",
           "ImageFolderDataSet", "ImageRecordWriter", "Lambda",
           "LocalDataSet", "MiniBatch", "PaddingParam", "PipelineDataSet",
           "Sample", "SampleToMiniBatch", "SequenceFileWriter",
           "ShardedDataSet", "SparseFeature", "TransformedDataSet",
           "Transformer", "array_to_samples", "batch_signature",
           "decode_image", "device_prefetch", "list_image_folder",
           "load_mnist", "load_ptb", "minibatch_input_to_device",
           "ptb_arrays", "read_image_records", "read_seq_image_records",
           "read_sequence_file", "read_words", "samples_to_minibatch",
           "stack_minibatches", "stack_windows", "tokenize",
           "write_image_record_shards", "write_seq_image_shards"]
