"""Datasets, samples and batching (counterpart of
``bigdl_tpu.dataset``): in-memory and sharded datasets, the image
transformers and the threaded ImageNet feed from a folder, record
shards or SequenceFiles, the copy to the card, the decoded image cache
on the card and its rotating shards, the native C++ loader's dataset,
the text readers and sentence transformers, and the corpus fetchers
(``dataset.fetch``)."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet, PipelineDataSet,
                                             ShardedDataSet,
                                             TransformedDataSet,
                                             array_to_samples)
from bigdl_tpu_torch.dataset.device_dataset import (DeviceCachedArrayDataSet,
                                                    RotatingDeviceDataSet,
                                                    ShardRotator)
from bigdl_tpu_torch.dataset.fetch import (get_glove_w2v, get_news20,
                                           maybe_download,
                                           mnist_read_data_sets,
                                           movielens_read_data_sets)
from bigdl_tpu_torch.dataset.image import load_mnist
from bigdl_tpu_torch.dataset.imagenet import (IMAGENET_MEAN, IMAGENET_STD,
                                              ImageFolderDataSet,
                                              ImageRecordWriter,
                                              decode_image,
                                              list_image_folder,
                                              read_image_records,
                                              write_image_record_shards)
from bigdl_tpu_torch.dataset.native_dataset import (NativeArrayDataSet,
                                                    native_available)
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
from bigdl_tpu_torch.dataset.text import (SENTENCE_END, SENTENCE_START,
                                          Dictionary, LabeledSentence,
                                          LabeledSentenceToSample,
                                          SentenceBiPadding, SentenceSplitter,
                                          SentenceTokenizer,
                                          TextToLabeledSentence, load_ptb,
                                          ptb_arrays, read_words, tokenize)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer, Lambda,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "DeviceCachedArrayDataSet", "Dictionary", "HostBatchedCOO",
           "IMAGENET_MEAN", "IMAGENET_STD", "ImageFolderDataSet",
           "ImageRecordWriter", "LabeledSentence", "LabeledSentenceToSample",
           "Lambda", "LocalDataSet", "MiniBatch", "NativeArrayDataSet",
           "PaddingParam", "PipelineDataSet", "RotatingDeviceDataSet",
           "Sample", "SampleToMiniBatch", "SentenceBiPadding",
           "SentenceSplitter", "SentenceTokenizer", "SequenceFileWriter",
           "ShardRotator", "ShardedDataSet", "SparseFeature",
           "SENTENCE_END", "SENTENCE_START", "TextToLabeledSentence",
           "TransformedDataSet", "Transformer", "array_to_samples",
           "batch_signature", "decode_image", "device_prefetch",
           "get_glove_w2v", "get_news20", "list_image_folder", "load_mnist",
           "load_ptb", "maybe_download", "minibatch_input_to_device",
           "mnist_read_data_sets", "movielens_read_data_sets",
           "native_available", "ptb_arrays",
           "read_image_records", "read_seq_image_records",
           "read_sequence_file", "read_words", "samples_to_minibatch",
           "stack_minibatches", "stack_windows", "tokenize",
           "write_image_record_shards", "write_seq_image_shards"]
