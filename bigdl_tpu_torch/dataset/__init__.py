"""Datasets, samples and batching (counterpart of
``bigdl_tpu.dataset``): the in-memory slice the training path reads."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.image import load_mnist
from bigdl_tpu_torch.dataset.sample import (HostBatchedCOO, MiniBatch,
                                            PaddingParam, Sample,
                                            SparseFeature,
                                            minibatch_input_to_device,
                                            samples_to_minibatch)
from bigdl_tpu_torch.dataset.text import (Dictionary, load_ptb, ptb_arrays,
                                          read_words, tokenize)
from bigdl_tpu_torch.dataset.transformer import (SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "DataSet", "Dictionary", "HostBatchedCOO",
           "LocalDataSet", "MiniBatch", "PaddingParam", "Sample",
           "SampleToMiniBatch", "SparseFeature", "TransformedDataSet",
           "Transformer", "load_mnist", "load_ptb",
           "minibatch_input_to_device", "ptb_arrays", "read_words",
           "samples_to_minibatch", "tokenize"]
