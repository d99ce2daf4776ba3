"""Weight regularizers (counterpart of ``bigdl_tpu.optim.regularizer``;
BigDL optim/Regularizer.scala:30).

The reference adds to the gradients inside accGradParameters; here, as
in the JAX package, a regularizer returns a penalty that joins the loss
and autograd gives the same gradient contribution (``l2 * w`` from
``0.5 * l2 * sum(w^2)``, ``l1 * sign(w)`` from ``l1 * sum(|w|)``).
"""
from __future__ import annotations

__all__ = ["L1L2Regularizer", "L1Regularizer", "L2Regularizer",
           "Regularizer"]


class Regularizer:
    """Weight-penalty contract: ``loss(w)`` joins the training
    objective."""

    def loss(self, w):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """optim/Regularizer.scala:87"""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def loss(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * w.abs().sum()
        if self.l2:
            out = out + 0.5 * self.l2 * (w * w).sum()
        return out


class L1Regularizer(L1L2Regularizer):
    """optim/Regularizer.scala:175"""

    def __init__(self, l1: float):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    """optim/Regularizer.scala:186"""

    def __init__(self, l2: float):
        super().__init__(l1=0.0, l2=l2)
