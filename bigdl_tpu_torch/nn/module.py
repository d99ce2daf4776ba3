"""The Module and Criterion contracts (counterpart of
``bigdl_tpu.nn.module``; BigDL nn/abstractnn/AbstractModule.scala:56).

The JAX package's Module is a declarative object over a functional core
(``init(rng)`` / ``apply(params, state, x)``) with a stateful layer on
top. The port is eager: :class:`Module` is a ``torch.nn.Module`` whose
parameters are its own tensors, and it carries the rest of the
reference contract:

- the constructor arguments, captured for every subclass as
  ``_init_args`` / ``_init_kwargs`` (the serializer rebuilds a module
  from them);
- a name (``set_name`` / ``get_name``);
- layer-wise gradient scales and freezing (``set_scale_w``,
  ``set_scale_b``, ``freeze``, ``unfreeze``, read by the train step
  through :meth:`Module.param_scales`);
- weight penalties (:meth:`Module.regularization_loss`,
  :func:`total_regularization`);
- ``evaluate()`` / ``is_training()``;
- the parameters and the state (buffers) as the JAX package's nested
  numpy trees (``get_parameters`` / ``set_parameters``, ``get_state``
  / ``set_state``, through :mod:`bigdl_tpu_torch.convert`), the
  gradients, and an eager
  ``backward(input, grad_output)`` through autograd;
- ``predict`` / ``evaluate_on`` sugar over the Predictor and Evaluator,
  and ``quantize()`` over :func:`bigdl_tpu_torch.nn.quantized.quantize`;
- the Graph wiring sugar: a module called with no argument, or with a
  graph :class:`~bigdl_tpu_torch.utils.directed_graph.Node` (or a
  ``(node, slot)`` pair) first, returns a new Node wired after those
  (the JAX package's ``Module.__call__``); any other call is torch's.

Where torch's names clash, torch's stay: ``training`` is torch's mode
flag (the JAX ``training()`` method is torch's ``train()``), and
``apply(fn)`` is torch's walk over submodules. The functional
``init`` / ``apply(params, state, x)`` core is not ported.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from bigdl_tpu_torch.convert import (export_params, export_state,
                                     load_jax_params, param_tree)
from bigdl_tpu_torch.utils.directed_graph import Node
from bigdl_tpu_torch.utils.table import Table

__all__ = ["Criterion", "Module", "total_regularization", "weight_penalty"]


def _map(fn, x):
    """``fn`` over the leaves of ``x`` (lists, tuples and Tables
    walked)."""
    if isinstance(x, Table):
        return Table({k: _map(fn, v) for k, v in x.items()})
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, e) for e in x)
    return fn(x)


def _grad_leaf(x):
    t = torch.as_tensor(x)
    if t.is_sparse:
        return t        # a sparse input passes untouched (no gradient)
    if t.is_floating_point():
        return t.detach().clone().requires_grad_()
    return t


def _grad_of(x):
    if not x.requires_grad:
        return None
    return x.grad if x.grad is not None else torch.zeros_like(x)


def _tensors(x):
    if isinstance(x, Table):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return [x] if isinstance(x, torch.Tensor) else []


class Module(nn.Module):
    """Base of every layer and container of the port
    (AbstractModule.scala:56)."""

    def __init_subclass__(cls, **kw):
        """Capture each subclass's constructor arguments, the outermost
        call's only, before ``torch.nn.Module.__init__`` has run: they
        are stored with ``object.__setattr__`` and never registered, as
        an argument may be a Module, a tensor or a ``torch.Generator``."""
        super().__init_subclass__(**kw)
        orig = cls.__dict__.get("__init__")
        if orig is None or getattr(orig, "_captures_args", False):
            return

        @functools.wraps(orig)
        def wrapped(self, *args, **kwargs):
            if "_init_args" not in self.__dict__:
                object.__setattr__(self, "_init_args", args)
                object.__setattr__(self, "_init_kwargs", kwargs)
            orig(self, *args, **kwargs)

        wrapped._captures_args = True
        cls.__init__ = wrapped

    def __init__(self):
        super().__init__()
        self._name: Optional[str] = None
        # layer-wise gradient scaling / freeze (setScaleW / setScaleB,
        # nn/Utils.scala:247); 0.0 is frozen
        self.scale_w: float = 1.0
        self.scale_b: float = 1.0

    # ---- penalties and scales ------------------------------------------
    def regularization_loss(self):
        """Sum of this module's regularizer penalties (0.0 without any):
        the reference applies them in accGradParameters
        (optim/Regularizer.scala:30); as a loss term autograd gives the
        same gradients."""
        return 0.0

    def param_scales(self) -> Dict[str, float]:
        """``{parameter name: scale}`` in ``named_parameters`` order: the
        factor the train step multiplies each gradient by. A leaf whose
        top-level key is ``bias`` takes ``scale_b``, every other leaf
        ``scale_w`` (containers defer to their children)."""
        return {name: (self.scale_b if name.split(".")[0] == "bias"
                       else self.scale_w)
                for name, _ in self.named_parameters()}

    # ---- metadata --------------------------------------------------------
    def set_name(self, name: str) -> "Module":
        self._name = name
        return self

    def get_name(self) -> str:
        return self._name or f"{type(self).__name__}{id(self) & 0xffff:04x}"

    def set_scale_w(self, s: float) -> "Module":
        self.scale_w = s
        return self

    def set_scale_b(self, s: float) -> "Module":
        self.scale_b = s
        return self

    def freeze(self) -> "Module":
        """Stop updates to this module's parameters
        (AbstractModule.freeze)."""
        self.scale_w = 0.0
        self.scale_b = 0.0
        return self

    def unfreeze(self) -> "Module":
        self.scale_w = 1.0
        self.scale_b = 1.0
        return self

    def evaluate(self) -> "Module":
        """Evaluation mode (torch's ``eval()``), returning the module."""
        self.eval()
        return self

    def is_training(self) -> bool:
        return self.training

    # ---- parameters as the JAX package's tree ---------------------------
    def get_parameters(self) -> Dict[str, object]:
        """The parameters as the JAX package's nested param tree of numpy
        arrays (:func:`bigdl_tpu_torch.convert.export_params`)."""
        return export_params(self)

    def set_parameters(self, params) -> "Module":
        """Copy a JAX-shaped param tree into the parameters in place
        (:func:`bigdl_tpu_torch.convert.load_jax_params`: every
        parameter covered, every leaf used)."""
        load_jax_params(self, params)
        return self

    def get_state(self) -> Dict[str, object]:
        """The model state (BatchNormalization's running statistics) as
        the JAX package's nested state tree of numpy arrays
        (:func:`bigdl_tpu_torch.convert.export_state`)."""
        return export_state(self)

    def set_state(self, state) -> "Module":
        """Copy a JAX-shaped state tree into the buffers in place
        (every buffer covered, every leaf used)."""
        load_jax_params(self, None, state)
        return self

    def zero_grad_parameters(self) -> "Module":
        for p in self.parameters():
            p.grad = None
        return self

    def get_grad_parameters(self) -> Optional[Dict[str, object]]:
        """The accumulated parameter gradients as a param tree (zeros for
        a parameter no backward reached), or None before any
        backward."""
        named = list(self.named_parameters())
        if all(p.grad is None for _, p in named):
            return None
        return param_tree((name, p.grad if p.grad is not None
                           else torch.zeros_like(p)) for name, p in named)

    def backward(self, input, grad_output):
        """Eager backward (AbstractModule.backward, :303): runs the
        forward again under autograd, returns the gradient with respect
        to ``input`` (None for a non-floating input) and accumulates the
        parameter gradients. A stochastic layer in training mode draws
        its noise anew."""
        x = _map(_grad_leaf, input)
        with torch.enable_grad():
            outs = _tensors(self(x))
            grads = [g.to(o.device, o.dtype) for o, g in zip(
                outs, _tensors(_map(torch.as_tensor, grad_output)))]
            torch.autograd.backward(outs, grads)
        return _map(_grad_of, x)

    # ---- sugar -----------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """A Node of this module wired after the given nodes when the
        first argument is a graph Node (or a ``(node, slot)`` pair) or
        there is no argument at all (Graph API sugar, ``Linear(4,
        3)(node)``, ``Input()()``); otherwise torch's call. The common
        case costs two type tests, then does what torch's ``__call__``
        (``_wrapped_call_impl``) does, in this frame."""
        if args:
            a = args[0]
            if type(a) is Node or (type(a) is tuple and a
                                   and type(a[0]) is Node):
                return Node(self)(*args)
        elif not kwargs:
            return Node(self)
        if self._compiled_call_impl is not None:
            return self._compiled_call_impl(*args, **kwargs)
        return self._call_impl(*args, **kwargs)

    def quantize(self) -> "Module":
        """The int8 inference rewrite (AbstractModule.quantize :708;
        :func:`bigdl_tpu_torch.nn.quantized.quantize`)."""
        from bigdl_tpu_torch.nn.quantized import quantize
        return quantize(self)

    def predict(self, dataset, batch_size: int = 32):
        """Batched predictions (optim/Predictor.scala:35), local path."""
        from bigdl_tpu_torch.optim.predictor import Predictor
        return Predictor(self).predict(dataset, batch_size=batch_size)

    def evaluate_on(self, dataset, methods, batch_size: int = 32):
        """Scored evaluation (optim/Evaluator.scala:37), local path."""
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        return Evaluator(self).test(dataset, methods, batch_size=batch_size)


class Criterion(Module):
    """Loss contract (nn/abstractnn/AbstractCriterion.scala):
    ``forward(input, target)`` returns a scalar loss tensor;
    ``backward(input, target)`` its gradient with respect to ``input``,
    from autograd."""

    def forward(self, input, target):
        raise NotImplementedError

    def backward(self, input, target):
        x = _map(_grad_leaf, input)
        with torch.enable_grad():
            self(x, target).backward()
        return _map(_grad_of, x)


def weight_penalty(layer: Module):
    """The penalties of a weight layer's ``w_regularizer`` (on
    ``weight``) and ``b_regularizer`` (on ``bias``, where it has one):
    Linear's and the convolutions' :meth:`~Module.regularization_loss`."""
    out = 0.0
    if layer.w_regularizer is not None:
        out = out + layer.w_regularizer.loss(layer.weight)
    if layer.b_regularizer is not None and layer.bias is not None:
        out = out + layer.b_regularizer.loss(layer.bias)
    return out


def total_regularization(module: Module):
    """Total regularization penalty of a module tree."""
    return module.regularization_loss()
