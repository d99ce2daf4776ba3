"""Optimization (counterpart of ``bigdl_tpu.optim``): the OptimMethod,
regularizers, triggers, validation methods, the single-card training
driver, and the local Predictor and Evaluator."""
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.optim_method import (Default, EpochDecay,
                                                LearningRateSchedule,
                                                OptimMethod, SGD)
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Optimizer,
                                             build_eval_step,
                                             build_train_step,
                                             make_host_window,
                                             seed_precision)
from bigdl_tpu_torch.optim.predictor import LocalPredictor, Predictor
from bigdl_tpu_torch.optim.regularizer import (L1L2Regularizer,
                                               L1Regularizer, L2Regularizer,
                                               Regularizer)
from bigdl_tpu_torch.optim.trigger import (Trigger, every_epoch, max_epoch,
                                           max_iteration, max_score,
                                           min_loss, several_iteration)
from bigdl_tpu_torch.optim.validation import (MAE, AccuracyResult, Loss,
                                              LossResult, Top1Accuracy,
                                              Top5Accuracy, ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Default", "EpochDecay", "Evaluator", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "LearningRateSchedule",
           "LocalOptimizer", "LocalPredictor", "Loss", "LossResult", "MAE",
           "OptimMethod", "Optimizer", "Predictor", "Regularizer", "SGD",
           "Top1Accuracy", "Top5Accuracy", "Trigger", "ValidationMethod",
           "ValidationResult", "build_eval_step", "build_train_step",
           "make_host_window", "seed_precision",
           "every_epoch", "max_epoch", "max_iteration", "max_score",
           "min_loss", "several_iteration"]
