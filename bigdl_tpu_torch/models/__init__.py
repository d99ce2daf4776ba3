"""Model families of the port (counterpart of ``bigdl_tpu.models``)."""
from bigdl_tpu_torch.models.lenet import LeNet5
from bigdl_tpu_torch.models.resnet import ResNet
from bigdl_tpu_torch.models.transformer import (FeedForward,
                                                TransformerBlock,
                                                TransformerLM)

__all__ = ["FeedForward", "LeNet5", "ResNet", "TransformerBlock",
           "TransformerLM"]
