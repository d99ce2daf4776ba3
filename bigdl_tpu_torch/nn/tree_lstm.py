"""Tree-structured LSTMs (counterpart of ``bigdl_tpu.nn.tree_lstm``;
BigDL nn/TreeLSTM.scala, nn/BinaryTreeLSTM.scala), as the
treeLSTMSentiment example uses them.

A tree is a node table in topological order, children before parents,
the root last:

    embeddings : [n_nodes, in]   the leaves' inputs (internal rows unread)
    children   : [n_nodes, 2]    indices into the table, -1 for none

A node whose first child is negative is a leaf. The JAX package runs one
``lax.scan`` over the nodes that computes the leaf and the composer at
every node, selects one with ``where`` and writes it into an ``[n, H]``
carry. The port walks the nodes in the same order and computes only the
selected branch (the same values, and the same gradients), each node's
``h`` and ``c`` a tensor of its own: no node table is copied per node.
A child index not yet computed (or a missing second child, read at
index 0 as the JAX ``maximum(kid, 0)`` reads it) reads zeros when the
JAX carry still holds them.

``children`` is read on the host: a tensor on the card is copied to the
host once per forward (one synchronisation).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["BinaryTreeLSTM", "TreeLSTM"]


class BinaryTreeLSTM(Module):
    """Constituency (binary) Tree-LSTM. Input ``(embeddings, children)``
    of one tree; output the per-node hidden states ``[n_nodes, hidden]``
    (the root is the last row; ``Select(1, -1)`` takes it).

    Parameters: ``w_leaf [3H, I]`` and ``b_leaf`` (the leaf's input,
    output and update gates, in that order), ``w_comp [5H, 2H]`` and
    ``b_comp`` (the composer's input gate, left and right forget gates,
    update and output gate, from ``[h_left, h_right]``); the weights
    ``U(-1/sqrt(H), 1/sqrt(H))``, the biases zero. ``gate_output=False``
    drops the output gate (``h = tanh(c)``).

    Embeddings of shape ``[B, n_nodes, in]`` run B trees of the one
    ``children`` table in one batched call, the rows as the JAX
    example's ``vmap`` gives them; the output is then ``[B, n_nodes,
    H]``. Parameters are built on the CPU from ``generator``."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.gate_output = gate_output
        h, i = hidden_size, input_size
        stdv = 1.0 / math.sqrt(h)
        dtype = default_dtype()

        def uniform(shape):
            return torch.empty(shape, dtype=dtype).uniform_(
                -stdv, stdv, generator=generator)

        self.w_leaf = nn.Parameter(uniform((3 * h, i)))
        self.b_leaf = nn.Parameter(torch.zeros(3 * h, dtype=dtype))
        self.w_comp = nn.Parameter(uniform((5 * h, 2 * h)))
        self.b_comp = nn.Parameter(torch.zeros(5 * h, dtype=dtype))

    def _out(self, o, c):
        return o * torch.tanh(c) if self.gate_output else torch.tanh(c)

    def _leaf(self, e):
        hh = self.hidden_size
        g = e @ self.w_leaf.T + self.b_leaf
        s = torch.sigmoid(g[..., :2 * hh])
        i, o = s[..., :hh], s[..., hh:]
        c = i * torch.tanh(g[..., 2 * hh:])
        return self._out(o, c), c

    def _compose(self, hl, cl, hr, cr):
        hh = self.hidden_size
        g = torch.cat([hl, hr], -1) @ self.w_comp.T + self.b_comp
        s = torch.sigmoid(g[..., :3 * hh])
        i, fl, fr = s[..., :hh], s[..., hh:2 * hh], s[..., 2 * hh:]
        u = torch.tanh(g[..., 3 * hh:4 * hh])
        o = torch.sigmoid(g[..., 4 * hh:])
        c = i * u + fl * cl + fr * cr
        return self._out(o, c), c

    def forward(self, table):
        emb, children = list(table)[:2]
        emb = torch.as_tensor(emb)
        if isinstance(children, torch.Tensor):
            children = children.cpu()      # the one host read a forward
        kids = np.asarray(children).astype(np.int64).reshape(-1, 2)
        n = kids.shape[0]
        batch = emb.shape[:-2]
        hs: list = [None] * n
        cs: list = [None] * n
        zero = emb.new_zeros(batch + (self.hidden_size,))

        def read(states, k):
            s = states[max(int(k), 0)]
            return zero if s is None else s

        for idx in range(n):
            left, right = kids[idx]
            if left < 0:
                hs[idx], cs[idx] = self._leaf(emb[..., idx, :])
            else:
                hs[idx], cs[idx] = self._compose(
                    read(hs, left), read(cs, left),
                    read(hs, right), read(cs, right))
        return torch.stack(hs, dim=-2)


class TreeLSTM(BinaryTreeLSTM):
    """The family's root (TreeLSTM.scala is the abstract base; the
    shipped composer is binary)."""
