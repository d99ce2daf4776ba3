"""Optimization (counterpart of ``bigdl_tpu.optim``): the OptimMethod,
triggers and the single-card training driver."""
from bigdl_tpu_torch.optim.optim_method import (Default,
                                                LearningRateSchedule,
                                                OptimMethod, SGD)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             build_train_step)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, several_iteration)

__all__ = ["Default", "LearningRateSchedule", "LocalOptimizer",
           "OptimMethod", "Optimizer", "SGD", "Trigger", "build_train_step",
           "every_epoch", "max_epoch", "max_iteration", "several_iteration"]
