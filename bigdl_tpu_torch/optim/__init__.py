"""Optimization (counterpart of ``bigdl_tpu.optim``): the OptimMethods
and their learning-rate schedules, LBFGS, regularizers, triggers,
validation methods, the training driver (one card, or a mesh of ranks:
``DistriOptimizer``), and the local Predictor and Evaluator."""
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.lbfgs import LBFGS
from bigdl_tpu_torch.optim.optim_method import (SGD, Adadelta, Adagrad, Adam,
                                                Adamax, Default, EpochDecay,
                                                EpochSchedule, EpochStep,
                                                Exponential, Ftrl,
                                                LearningRateSchedule,
                                                MultiStep, NaturalExp,
                                                OptimMethod, Plateau, Poly,
                                                Regime, RMSprop,
                                                SequentialSchedule, Step,
                                                Warmup)
from bigdl_tpu_torch.optim.optimizer import (DistriOptimizer,
                                             LocalOptimizer, Optimizer,
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
                                              Top5Accuracy, TreeNNAccuracy,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["AccuracyResult", "Adadelta", "Adagrad", "Adam", "Adamax",
           "Default", "DistriOptimizer", "EpochDecay", "EpochSchedule", "EpochStep",
           "Evaluator", "Exponential", "Ftrl", "L1L2Regularizer",
           "L1Regularizer", "L2Regularizer", "LBFGS",
           "LearningRateSchedule", "LocalOptimizer", "LocalPredictor",
           "Loss", "LossResult", "MAE", "MultiStep", "NaturalExp",
           "OptimMethod", "Optimizer", "Plateau", "Poly", "Predictor",
           "RMSprop", "Regime", "Regularizer", "SGD", "SequentialSchedule",
           "Step", "Top1Accuracy", "Top5Accuracy", "TreeNNAccuracy", "Trigger",
           "ValidationMethod", "ValidationResult", "Warmup",
           "build_eval_step", "build_train_step", "make_host_window",
           "seed_precision", "every_epoch", "max_epoch", "max_iteration",
           "max_score", "min_loss", "several_iteration"]
