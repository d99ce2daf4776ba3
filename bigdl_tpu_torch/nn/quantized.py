"""Int8 quantized inference modules and the model rewrite (counterpart
of ``bigdl_tpu.nn.quantized``; reference nn/quantized/{Linear,
SpatialConvolution,SpatialDilatedConvolution}.scala and
Quantization.scala:168).

:func:`quantize` rebuilds a float model with every Linear and
ungrouped SpatialConvolution replaced by an int8 twin whose state is
the quantized weight (int8, per-output-channel float32 scales), the
optional calibrated activation scale and the float bias — the JAX
package's quantized params, held as buffers under the same names
(``weight_q``, ``w_scale``, ``act_scale``, ``bias``). Inference only:
a quantized module in training mode raises, as in the JAX package.

:class:`QuantizedLinear` routes through the kernel dispatch: with int8
enabled it launches the fused dequant int8 GEMM (K5) on the card — on
the serving path, once per forward of ResNet-50's classifier — else
``ops.quant.quantized_linear`` runs; the two are bitwise equal.
:class:`QuantizedSpatialConvolution` is ``ops.quant.quantized_conv2d``
(im2col and an exact library integer product; no Pallas kernel in the
JAX package either).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.container import Container
from bigdl_tpu_torch.nn.conv import (SpatialConvolution,
                                     crop_negative_padding)
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.quant import (quantize_symmetric,
                                       quantize_with_scale,
                                       quantized_conv2d, quantized_linear)
from bigdl_tpu_torch.utils.directed_graph import Edge, Node
from bigdl_tpu_torch.utils.engine import full_float32

__all__ = ["QuantizedLinear", "QuantizedSpatialConvolution", "quantize"]


def _quantized_state(module: nn.Module, weight, bias,
                     act_scale: Optional[float]) -> None:
    """Register the JAX package's quantized params as buffers:
    per-output-channel int8 weight and scales, the calibrated
    activation scale (a float32 scalar) and the float bias."""
    q, scale = quantize_symmetric(weight.detach().float(), axis=0)
    module.register_buffer("weight_q", q)
    module.register_buffer("w_scale", scale.reshape(-1))
    module.register_buffer(
        "act_scale", None if act_scale is None else torch.tensor(
            act_scale, dtype=torch.float32, device=weight.device))
    module.register_buffer(
        "bias", None if bias is None else bias.detach().float().clone())


def _inference_only(module: nn.Module) -> None:
    if module.training:
        raise RuntimeError(
            f"{type(module).__name__} is inference-only (reference: "
            f"quantized modules have no backward); call .eval()")


class QuantizedLinear(Module):
    """Int8 FC (nn/quantized/Linear.scala:77-88). Build it from a float
    :class:`~bigdl_tpu_torch.nn.linear.Linear` with :meth:`from_float`
    or :func:`quantize`."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias

    @classmethod
    def from_float(cls, linear: Linear,
                   act_scale: Optional[float] = None) -> "QuantizedLinear":
        """``act_scale`` (a calibrated per-tensor activation scale from
        ``precision/calibrate.py``) switches the layer from dynamic
        per-row activation quantization to the static calibrated path —
        no amax reduce on the serving path."""
        m = cls(linear.input_size, linear.output_size, linear.with_bias)
        _quantized_state(m, linear.weight, linear.bias, act_scale)
        m._name = linear._name
        return m.train(linear.training)

    def forward(self, x):
        _inference_only(self)
        if isinstance(x, torch.Tensor) and x.is_sparse:
            # a quantized SparseLinear: the int8 path takes dense rows
            # only, and the JAX package's raises on the sparse input too
            raise TypeError(
                f"{type(self).__name__} takes a dense input; got a sparse "
                f"COO input of shape {tuple(x.shape)} (the int8 path has "
                f"no sparse product: keep a SparseLinear float)")
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        lead = x.shape[:-1]
        out = self._dispatch(x.reshape(-1, x.shape[-1]))
        out = out.reshape(lead + (self.output_size,))
        return out[0] if squeeze else out

    def _dispatch(self, x2):
        from bigdl_tpu_torch import kernels

        m = x2.shape[0]
        if kernels.enabled("int8"):
            x32 = x2.float()
            if self.act_scale is None:
                x_q, x_scale = quantize_symmetric(x32, axis=0)
                x_scale = x_scale.reshape(-1)
            else:
                x_scale = self.act_scale.float().expand(m)
                x_q = quantize_with_scale(x32, x_scale.reshape(-1, 1))
            # K5, or None on a CPU shape decline; the plain path below
            # then runs on the SAME quantization it always did
            out = kernels.int8_matmul(x_q, self.weight_q, x_scale,
                                      self.w_scale, self.bias)
            if out is not None:
                return out
        return quantized_linear(x2, self.weight_q, self.w_scale, self.bias,
                                x_scale=self.act_scale)


class QuantizedSpatialConvolution(Module):
    """Int8 NCHW conv (nn/quantized/SpatialConvolution.scala; dilation
    covers SpatialDilatedConvolution too, through a float convolution on
    the dequantized weight, as in the JAX package)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int, stride_w: int = 1,
                 stride_h: int = 1, pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, dilation_w: int = 1, dilation_h: int = 1,
                 with_bias: bool = True):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.dilation_w, self.dilation_h = dilation_w, dilation_h
        self.with_bias = with_bias

    @classmethod
    def from_float(cls, conv: SpatialConvolution,
                   act_scale: Optional[float] = None
                   ) -> "QuantizedSpatialConvolution":
        m = cls(conv.n_input_plane, conv.n_output_plane, conv.kernel_w,
                conv.kernel_h, conv.stride_w, conv.stride_h, conv.pad_w,
                conv.pad_h, conv.n_group, getattr(conv, "dilation_w", 1),
                getattr(conv, "dilation_h", 1), conv.with_bias)
        _quantized_state(m, conv.weight, conv.bias, act_scale)
        m._name = conv._name
        return m.train(conv.training)

    def forward(self, x):
        _inference_only(self)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if self.dilation_w != 1 or self.dilation_h != 1:
            # float conv on the dequantized weight (int8 dequant math is
            # float32 by contract)
            if x.is_cuda:
                full_float32()
            w = self.weight_q.float() * self.w_scale.reshape(-1, 1, 1, 1)
            xc, pad_h, pad_w = crop_negative_padding(x.float(), self.pad_h,
                                                     self.pad_w)
            out = F.conv2d(xc, w, None,
                           (self.stride_h, self.stride_w), (pad_h, pad_w),
                           (self.dilation_h, self.dilation_w), self.n_group)
            if self.bias is not None:
                out = out + self.bias.reshape(1, -1, 1, 1)
        else:
            out = quantized_conv2d(
                x, self.weight_q, self.w_scale, self.bias,
                stride=(self.stride_h, self.stride_w),
                padding=[(self.pad_h, self.pad_h), (self.pad_w, self.pad_w)],
                n_group=self.n_group, x_scale=self.act_scale)
        return out[0] if squeeze else out


def _convert(m: nn.Module, scale: Optional[float]) -> Optional[nn.Module]:
    """The int8 twin of a quantizable module, else None."""
    if isinstance(m, Linear):
        return QuantizedLinear.from_float(m, scale)
    if isinstance(m, SpatialConvolution) and m.n_group == 1:
        return QuantizedSpatialConvolution.from_float(m, scale)
    return None


def quantize(model: nn.Module,
             act_scales: Optional[Dict[int, float]] = None) -> nn.Module:
    """Rewrite a trained model for int8 inference (Quantization.scala:
    168). Returns a NEW module tree in evaluation mode; ``model`` is
    untouched.

    The walk is the JAX package's ``convert``: the model itself when it
    is a Linear or an ungrouped SpatialConvolution, else the children of
    a container (``Sequential``, ``Concat``, ``ConcatTable``) and the
    nodes of a ``Graph``, recursively. Any other module is copied float
    with everything inside it: a ``Recurrent``'s cell, a
    ``TimeDistributed``'s Linear, a ``TransformerLM``'s products stay
    float, as in the JAX package.

    ``act_scales`` — ``{id(module): activation_scale}`` from
    :func:`bigdl_tpu_torch.precision.calibrate.
    collect_activation_scales`, keyed by the FLOAT model's modules:
    calibrated layers bake their static activation scale in; absent
    layers keep the dynamic per-batch estimate."""
    return _rewrite(model, act_scales or {}).eval()


def _rewrite(m: nn.Module, act_scales: Dict[int, float]) -> nn.Module:
    q = _convert(m, act_scales.get(id(m)))
    if q is not None:
        return q
    if isinstance(m, Graph):
        # new nodes and edges, so the original graph stays as it is
        new = [Node(_rewrite(n.element, act_scales)) for n in m.exec_order]
        pos = {id(n): i for i, n in enumerate(m.exec_order)}
        for n in m.exec_order:
            for p, e in n.prevs:
                new[pos[id(p)]].add(new[pos[id(n)]], Edge(e.from_index))
        return Graph([new[pos[id(n)]] for n in m.input_nodes],
                     [new[pos[id(n)]] for n in m.output_nodes])
    if isinstance(m, Container):
        out = copy.copy(m)
        out.__dict__.update(
            _parameters=dict(m._parameters), _buffers=dict(m._buffers),
            _modules={k: _rewrite(c, act_scales)
                      for k, c in m._modules.items()})
        # the children given to the constructor are arguments of the
        # spec (module_serializer.to_spec): the rewritten ones
        children = iter(out._modules.values())
        out._init_args = tuple(next(children) if isinstance(a, Module)
                               else a for a in m._init_args)
        return out
    return copy.deepcopy(m)
