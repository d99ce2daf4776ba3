"""Datasets, samples and batching (counterpart of
``bigdl_tpu.dataset``): the in-memory slice the training path reads."""
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.sample import (MiniBatch, Sample,
                                            samples_to_minibatch)
from bigdl_tpu_torch.dataset.text import ptb_arrays
from bigdl_tpu_torch.dataset.transformer import (SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet", "MiniBatch",
           "Sample", "SampleToMiniBatch", "TransformedDataSet",
           "Transformer", "ptb_arrays", "samples_to_minibatch"]
