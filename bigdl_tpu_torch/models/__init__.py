"""Model families of the port (counterpart of ``bigdl_tpu.models``).

Not ported yet: ``PipelinedTransformerLM`` (ROADMAP queue 1, item
11)."""
from bigdl_tpu_torch.models.alexnet import AlexNet, AlexNet_OWT
from bigdl_tpu_torch.models.autoencoder import Autoencoder
from bigdl_tpu_torch.models.inception import (Inception_v1,
                                              Inception_v1_NoAuxClassifier,
                                              Inception_v2,
                                              Inception_v2_NoAuxClassifier)
from bigdl_tpu_torch.models.lenet import LeNet5, LeNet5_graph
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.rnn import PTBModel, SimpleRNN, WordRNN
from bigdl_tpu_torch.models.transformer import (FeedForward,
                                                TransformerBlock,
                                                TransformerLM)
from bigdl_tpu_torch.models.vgg import VggForCifar10, Vgg_16, Vgg_19

__all__ = ["AlexNet", "AlexNet_OWT", "Autoencoder", "FeedForward",
           "Inception_v1", "Inception_v1_NoAuxClassifier", "Inception_v2",
           "Inception_v2_NoAuxClassifier", "LeNet5", "LeNet5_graph",
           "PTBModel", "ResNet", "SimpleRNN", "TransformerBlock",
           "TransformerLM", "VggForCifar10", "Vgg_16", "Vgg_19", "WordRNN"]
