"""The recurrent stack (counterpart of ``bigdl_tpu.nn.recurrent``; BigDL
nn/{Recurrent,Cell,RNN,LSTM,LSTMPeephole,GRU,ConvLSTMPeephole,
ConvLSTMPeephole3D,BiRecurrent,RecurrentDecoder,TimeDistributed}.scala).

A cell is a module with ``step(x, hidden, generator=None) -> (out,
hidden)``; :class:`Recurrent` unrolls it over the time axis of a
batch-first ``(B, T, ...)`` input. The JAX package runs the unroll as
one ``lax.scan`` through XLA, with no Pallas kernel; the port runs it
as a Python loop of plain torch ops (cuBLAS products and elementwise
passes), which a K-step window captures into one CUDA graph.

Each cell keeps one copy of its gate math, in ``step_projected(gx,
hidden)``, where ``gx`` is the input's half of the gates; ``step``
derives from it. When the cell draws nothing, :class:`Recurrent`
computes ``project_input`` for every time step in one ``[T·B, I] x [I,
gH]`` product and runs only the recurrent half step by step. A cell
that draws (an ``LSTM`` with ``p > 0`` in training, or one whose
``uses_rng`` says so) takes the per-step path, as in the JAX package;
its masks come from the step's ``torch.Generator`` through
:func:`~bigdl_tpu_torch.nn.dropout.keep_mask`, the one draw site. The
JAX ``GRU`` applies no dropout although its ``p`` sends it down the
per-step path; the port mirrors both.

Weights keep the JAX package's names and ``[out, in]`` layouts
(``w_ih``, ``w_hh``, ``bias``, ...), drawn on the CPU from
``generator``. Hidden state is a tensor, or ``T(h, c)`` for the LSTMs,
as in the JAX package.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import dropout as _dropout
from bigdl_tpu_torch.nn.container import _run
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.engine import default_dtype, full_float32
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["BiRecurrent", "Cell", "ConvLSTMPeephole", "ConvLSTMPeephole3D",
           "GRU", "LSTM", "LSTMPeephole", "Recurrent", "RecurrentDecoder",
           "RnnCell", "TimeDistributed"]


def _uniform(shape, stdv: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=default_dtype()).uniform_(
        -stdv, stdv, generator=generator))


def _zeros(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=default_dtype()))


def _affine(x, w, b):
    """``x @ w.T + b`` over the last axis, as one ``addmm``."""
    lead = x.shape[:-1]
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), w.t()).reshape(
        lead + (w.shape[0],))


def _penalty(cell, w_names) -> float:
    """The cell's ``w_regularizer`` on ``w_ih``, ``u_regularizer`` on
    ``w_hh`` and ``b_regularizer`` on ``bias``."""
    out = 0.0
    for reg, name in zip((cell.w_regularizer, cell.u_regularizer,
                          cell.b_regularizer), w_names):
        if reg is not None:
            out = out + reg.loss(getattr(cell, name))
    return out


class Cell(Module):
    """Recurrent cell contract (nn/Cell.scala:47)."""

    #: does ``step`` draw? None: derived from the dropout convention, a
    #: ``p`` attribute other than 0. A stochastic cell that does not
    #: follow it sets True, or Recurrent takes the projected path and
    #: passes it no generator.
    uses_rng: Optional[bool] = None

    def consumes_rng(self) -> bool:
        if self.uses_rng is not None:
            return self.uses_rng
        return getattr(self, "p", 0.0) != 0.0

    def init_hidden(self, batch_size: int, like: torch.Tensor):
        """The zero hidden state of a batch, in ``like``'s dtype and on
        its device (Cell.hidResize, Cell.scala:104)."""
        raise NotImplementedError

    def step(self, x, hidden, generator: Optional[torch.Generator] = None):
        """One time step: ``(output, new_hidden)``."""
        raise NotImplementedError

    def forward(self, input, generator: Optional[torch.Generator] = None):
        """A cell used alone maps ``T(x, hidden)`` (or ``[x, hidden]``)
        to ``T(out, hidden)``, as the reference's Cell.forward."""
        x, hidden = (input[1], input[2]) if isinstance(input, Table) \
            else input
        out, h = self.step(x, hidden, generator)
        return T(out, h)


class RnnCell(Cell):
    """Vanilla RNN cell ``h' = act(x W_ih^T + b + h W_hh^T)``
    (nn/RNN.scala)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: Optional[Module] = None,
                 isInputWithBias: bool = True,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from bigdl_tpu_torch.nn.activation import Tanh
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation or Tanh()
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_ih = _uniform((hidden_size, input_size), stdv, generator)
        self.w_hh = _uniform((hidden_size, hidden_size), stdv, generator)
        self.bias = _uniform((hidden_size,), stdv, generator)

    def init_hidden(self, batch_size, like):
        return like.new_zeros((batch_size, self.hidden_size))

    def step(self, x, hidden, generator=None):
        return self.step_projected(self.project_input(x), hidden)

    def project_input(self, xs):
        """The input's half for all time steps in one product."""
        return _affine(xs, self.w_ih, self.bias)

    def step_projected(self, gx, hidden):
        h = self.activation(torch.addmm(gx, hidden, self.w_hh.t()))
        return h, h

    def regularization_loss(self):
        return _penalty(self, ("w_ih", "w_hh", "bias"))


class LSTM(Cell):
    """Standard LSTM (nn/LSTM.scala): gates ``i, f, g, o`` in one
    ``[4H, in]`` product each for the input and the hidden state;
    hidden ``T(h, c)``. With ``p > 0`` a training step drops the input
    and ``h`` (each kept with probability ``1 - p`` and scaled by ``1 /
    (1 - p)``) before the products, the input's mask drawn first."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation: Optional[Module] = None,
                 inner_activation: Optional[Module] = None,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_ih = _uniform((4 * hidden_size, input_size), stdv, generator)
        self.w_hh = _uniform((4 * hidden_size, hidden_size), stdv,
                             generator)
        self.bias = _uniform((4 * hidden_size,), stdv, generator)

    def init_hidden(self, batch_size, like):
        z = like.new_zeros((batch_size, self.hidden_size))
        return T(z, z)

    def step(self, x, hidden, generator=None):
        h, c = hidden[1], hidden[2]
        if self.p > 0 and self.training and generator is not None:
            x = torch.where(_dropout.keep_mask(x.shape, self.p, generator),
                            x / (1 - self.p), 0.0)
            h = torch.where(_dropout.keep_mask(h.shape, self.p, generator),
                            h / (1 - self.p), 0.0)
        return self.step_projected(self.project_input(x), T(h, c))

    def project_input(self, xs):
        """``x W_ih^T + b`` for all time steps in one ``[T·B, I] x [I,
        4H]`` product; the loop keeps only ``h W_hh^T``."""
        return _affine(xs, self.w_ih, self.bias)

    def step_projected(self, gx, hidden):
        h, c = hidden[1], hidden[2]
        i, f, g, o = torch.addmm(gx, h, self.w_hh.t()).chunk(4, -1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c2 = f * c + i * torch.tanh(g)
        h2 = o * torch.tanh(c2)
        return h2, T(h2, c2)

    def regularization_loss(self):
        return _penalty(self, ("w_ih", "w_hh", "bias"))


class LSTMPeephole(LSTM):
    """LSTM with peephole connections (nn/LSTMPeephole.scala): ``c``
    into the input and forget gates, ``c'`` into the output gate
    (``w_ci``, ``w_cf``, ``w_co``)."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 activation: Optional[Module] = None,
                 inner_activation: Optional[Module] = None,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden_size, p, activation,
                         inner_activation, w_regularizer, u_regularizer,
                         b_regularizer, generator)
        stdv = 1.0 / math.sqrt(hidden_size)
        self.w_ci = _uniform((hidden_size,), stdv, generator)
        self.w_cf = _uniform((hidden_size,), stdv, generator)
        self.w_co = _uniform((hidden_size,), stdv, generator)

    def step_projected(self, gx, hidden):
        h, c = hidden[1], hidden[2]
        i, f, g, o = torch.addmm(gx, h, self.w_hh.t()).chunk(4, -1)
        i = torch.sigmoid(i + self.w_ci * c)
        f = torch.sigmoid(f + self.w_cf * c)
        c2 = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + self.w_co * c2)
        h2 = o * torch.tanh(c2)
        return h2, T(h2, c2)


class GRU(Cell):
    """GRU (nn/GRU.scala), the JAX package's form: gates ``r, z`` from
    ``[2H, ·]`` products, the candidate ``tanh(x W_ih_n^T + bias_n + r *
    (h W_hh_n^T))`` with no hidden bias, ``bias_n`` zero at init;
    ``h' = (1 - z) n + z h``. ``p`` selects the per-step path and drops
    nothing, as in the JAX package."""

    def __init__(self, input_size: int, hidden_size: int, p: float = 0.0,
                 w_regularizer=None, u_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.p = p
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        H, I = hidden_size, input_size
        stdv = 1.0 / math.sqrt(H)
        self.w_ih = _uniform((2 * H, I), stdv, generator)
        self.w_hh = _uniform((2 * H, H), stdv, generator)
        self.bias = _uniform((2 * H,), stdv, generator)
        self.w_ih_n = _uniform((H, I), stdv, generator)
        self.w_hh_n = _uniform((H, H), stdv, generator)
        self.bias_n = _zeros((H,))

    def init_hidden(self, batch_size, like):
        return like.new_zeros((batch_size, self.hidden_size))

    def step(self, x, hidden, generator=None):
        return self.step_projected(self.project_input(x), hidden)

    def project_input(self, xs):
        """Both input halves (the gates and the candidate) for all time
        steps, two products."""
        return (_affine(xs, self.w_ih, self.bias),
                _affine(xs, self.w_ih_n, self.bias_n))

    def step_projected(self, gx, hidden):
        gx_rz, gx_n = gx
        h = hidden
        r, z = torch.sigmoid(
            torch.addmm(gx_rz, h, self.w_hh.t())).chunk(2, -1)
        n = torch.tanh(gx_n + r * (h @ self.w_hh_n.t()))
        h2 = (1.0 - z) * n + z * h
        return h2, h2

    def regularization_loss(self):
        # the JAX GRU declares the regularizers and applies none
        return 0.0


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM with peepholes over NCHW maps
    (nn/ConvLSTMPeephole.scala): hidden ``T(h, c)``, each ``(B, C_out,
    H, W)``. A kernel of size ``k`` pads ``(k - 1) // 2`` before and
    ``k - 1 - (k - 1) // 2`` after, as the JAX package does (uneven for
    an even ``k``)."""

    spatial_dims = 2

    def __init__(self, input_size: int, output_size: int,
                 kernel_i: int = 3, kernel_c: int = 3, stride: int = 1,
                 with_peephole: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.kernel_i = kernel_i
        self.kernel_c = kernel_c
        self.stride = stride
        self.with_peephole = with_peephole
        ci, co, d = input_size, output_size, self.spatial_dims
        stdv = 1.0 / math.sqrt(ci * kernel_i ** d)
        self.w_xi = _uniform((4 * co, ci) + (kernel_i,) * d, stdv, generator)
        self.w_hi = _uniform((4 * co, co) + (kernel_c,) * d,
                             1.0 / math.sqrt(co * kernel_c ** d), generator)
        self.bias = _zeros((4 * co,))
        if with_peephole:
            self.w_ci = _uniform((co,), stdv, generator)
            self.w_cf = _uniform((co,), stdv, generator)
            self.w_co = _zeros((co,))

    def _conv(self, x, w, k):
        if x.is_cuda:
            full_float32()
        lo = (k - 1) // 2
        hi = k - 1 - lo
        conv = F.conv2d if self.spatial_dims == 2 else F.conv3d
        if lo != hi:
            x = F.pad(x, (lo, hi) * self.spatial_dims)
            lo = 0
        return conv(x, w, None, self.stride, lo)

    def _channels(self, v):
        return v.reshape((1, -1) + (1,) * self.spatial_dims)

    def init_hidden(self, batch_size, like, spatial=None):
        z = like.new_zeros((batch_size, self.output_size) + tuple(spatial))
        return T(z, z)

    def step(self, x, hidden, generator=None):
        h, c = hidden[1], hidden[2]
        gates = self._conv(x, self.w_xi, self.kernel_i) \
            + self._conv(h, self.w_hi, self.kernel_c) \
            + self._channels(self.bias)
        i, f, g, o = gates.chunk(4, 1)
        if self.with_peephole:
            i = i + self._channels(self.w_ci) * c
            f = f + self._channels(self.w_cf) * c
        i, f = torch.sigmoid(i), torch.sigmoid(f)
        c2 = f * c + i * torch.tanh(g)
        if self.with_peephole:
            o = o + self._channels(self.w_co) * c2
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, T(h2, c2)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """The 3-D variant over NCDHW maps (nn/ConvLSTMPeephole3D.scala)."""

    spatial_dims = 3


class Recurrent(Module):
    """Time-unrolling container (nn/Recurrent.scala:36): ``(B, T, ...)``
    to ``(B, T, hidden)``, the hidden state starting at zero. A cell
    that draws in training (:meth:`Cell.consumes_rng`) takes the
    per-step path and needs ``generator``; any other cell with a
    ``project_input`` takes the projected path (module docstring)."""

    def __init__(self, cell: Optional[Cell] = None):
        super().__init__()
        self.cell = cell

    def add(self, cell: Cell) -> "Recurrent":
        self.cell = cell
        return self

    def _h0(self, x):
        if isinstance(self.cell, ConvLSTMPeephole):
            return self.cell.init_hidden(x.shape[0], x, spatial=x.shape[3:])
        return self.cell.init_hidden(x.shape[0], x)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        cell = self.cell
        h = self._h0(x)
        xs = x.transpose(0, 1)
        outs = []
        draws = self.training and cell.consumes_rng()
        if not draws and hasattr(cell, "project_input"):
            gx = cell.project_input(xs)
            steps = zip(*gx) if isinstance(gx, tuple) else gx
            for gx_t in steps:
                out, h = cell.step_projected(gx_t, h)
                outs.append(out)
        else:
            if draws and generator is None:
                raise ValueError(f"Recurrent over a {type(cell).__name__} "
                                 f"that draws requires a generator in "
                                 f"training mode")
            for x_t in xs:
                out, h = cell.step(x_t, h, generator)
                outs.append(out)
        return torch.stack(outs, 1)

    def regularization_loss(self):
        return self.cell.regularization_loss()


class BiRecurrent(Module):
    """Bidirectional recurrence (nn/BiRecurrent.scala): a forward
    ``Recurrent`` and one over the time-reversed input, each with its
    own copy of the cell (the backward cell a deep copy), the outputs
    concatenated on the feature axis or given to ``merge`` as a table
    (``CAddTable``). The forward direction draws first from
    ``generator``."""

    def __init__(self, merge: Optional[Module] = None,
                 cell: Optional[Cell] = None):
        super().__init__()
        self.merge = merge
        self.fwd = Recurrent(cell)
        self.bwd = Recurrent(copy.deepcopy(cell))

    def add(self, cell: Cell) -> "BiRecurrent":
        self.fwd.add(cell)
        self.bwd.add(copy.deepcopy(cell))
        return self

    def forward(self, x, generator: Optional[torch.Generator] = None):
        yf = self.fwd(x, generator=generator)
        yb = self.bwd(x.flip(1), generator=generator).flip(1)
        if self.merge is not None:
            return self.merge([yf, yb])
        return torch.cat([yf, yb], dim=-1)


class RecurrentDecoder(Module):
    """Feeds each output back as the next input for ``seq_length``
    steps (nn/RecurrentDecoder.scala): input ``(B, F)``, the start
    symbol; output ``(B, seq_length, hidden)``. The cell draws nothing,
    as in the JAX package."""

    def __init__(self, seq_length: int, cell: Optional[Cell] = None):
        super().__init__()
        self.seq_length = seq_length
        self.cell = cell

    def add(self, cell: Cell) -> "RecurrentDecoder":
        self.cell = cell
        return self

    def forward(self, x):
        h = self.cell.init_hidden(x.shape[0], x)
        outs = []
        for _ in range(self.seq_length):
            x, h = self.cell.step(x, h)
            outs.append(x)
        return torch.stack(outs, 1)


class TimeDistributed(Module):
    """Applies ``layer`` to every time slice of ``(B, T, ...)``
    (nn/TimeDistributed.scala) by folding the time axis into the batch:
    one product for the LM head. ``generator`` goes to a layer whose
    forward takes one."""

    #: the JAX trees hold ``{"layer": ...}`` even for a parameterless
    #: layer
    jax_tree_children = ("layer",)

    def __init__(self, layer: Module):
        super().__init__()
        self.layer = layer

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, t = x.shape[0], x.shape[1]
        out = _run(self.layer, x.reshape((b * t,) + x.shape[2:]), generator)
        return out.reshape((b, t) + out.shape[1:])

    def regularization_loss(self):
        return self.layer.regularization_loss()
