"""Tree-LSTM sentiment (counterpart of the JAX package's
``examples/tree_lstm_sentiment.py``; BigDL example/treeLSTMSentiment): a
constituency ``BinaryTreeLSTM`` over embedded tokens, classified at the
root, scored with ``TreeNNAccuracy``.

Trees are full binary trees over token leaves; a tree's sentiment is the
majority polarity of its leaf tokens (a synthetic stand-in for the SST
data the reference downloads). All trees share one topology, so the
batch runs as one batched ``BinaryTreeLSTM`` call (the JAX example's
``vmap``), one full-batch SGD step an epoch.

    python -m bigdl_tpu_torch.examples.tree_lstm_sentiment --trees 200 \
        --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.examples._common import (add_device_flag,
                                              example_device,
                                              seeded_generator)
from bigdl_tpu_torch.optim import SGD, TreeNNAccuracy

__all__ = ["TreeSentiment", "build_full_tree", "main", "make_data",
           "train"]


def build_full_tree(n_leaves):
    """Children table of a full binary tree, nodes topologically ordered
    leaves first, the root last (BinaryTreeLSTM's contract); -1 marks a
    leaf."""
    children = [[-1, -1] for _ in range(n_leaves)]
    frontier = list(range(n_leaves))
    while len(frontier) > 1:
        nxt = []
        for i in range(0, len(frontier) - 1, 2):
            children.append([frontier[i], frontier[i + 1]])
            nxt.append(len(children) - 1)
        if len(frontier) % 2 == 1:
            nxt.append(frontier[-1])
        frontier = nxt
    return np.asarray(children, np.int32)


def make_data(trees: int, leaves: int, vocab: int, seed: int = 0):
    """``(tokens [trees, leaves], labels [trees])``: tokens 1..V/2 are
    negative, V/2+1..V positive; the label is the majority polarity
    (1 or 2, 1-based). The JAX example's ``numpy.random`` calls."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, vocab + 1, (trees, leaves)).astype(np.int32)
    labels = 1.0 + ((tokens > vocab // 2).mean(axis=1) > 0.5)
    return tokens, labels


class TreeSentiment(nn.Module):
    """Embedding, ``BinaryTreeLSTM(H, H)`` and a ``Linear(H, 2)`` head on
    the root: ``forward(tokens [B, leaves]) -> logits [B, 2]``. Leaves
    embed their token; the internal nodes' inputs are zero."""

    def __init__(self, vocab: int, hidden: int, leaves: int,
                 generator=None):
        super().__init__()
        self.leaves = leaves
        self.children_table = build_full_tree(leaves)
        self.tree = nn.BinaryTreeLSTM(hidden, hidden, generator=generator)
        self.embed = nn.LookupTable(vocab, hidden, generator=generator)
        self.head = nn.Linear(hidden, 2, generator=generator)

    def forward(self, tokens):
        leaf = self.embed(tokens)                       # [B, L, H]
        n = len(self.children_table)
        emb = torch.cat([leaf, leaf.new_zeros(
            leaf.shape[:-2] + (n - self.leaves, leaf.shape[-1]))], -2)
        hs = self.tree([emb, self.children_table])      # [B, n, H]
        return self.head(hs[..., -1, :])                # the root


def train(model: TreeSentiment, tokens, labels, epochs: int, lr: float,
          on_step=None):
    """``epochs`` full-batch steps of SGD (momentum 0.9) on
    ``CrossEntropyCriterion``, as the JAX example steps; returns the
    losses as tensors (no host read a step). ``on_step(grads)`` may
    change the gradients before the update (a fault in a check)."""
    crit = nn.CrossEntropyCriterion()
    optim = SGD(learning_rate=lr, momentum=0.9)
    params = list(model.parameters())
    state = optim.init_state(params)
    losses = []
    for _ in range(epochs):
        step_lr = optim.update_hyper_parameter()
        loss = crit(model(tokens), labels)
        grads = list(torch.autograd.grad(loss, params))
        if on_step is not None:
            on_step(grads)
        optim.update(grads, state, params, step_lr)
        losses.append(loss.detach())
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trees", type=int, default=200)
    ap.add_argument("--leaves", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=40)
    ap.add_argument("--hidden", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.5)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = example_device(args.device)

    tokens, labels = make_data(args.trees, args.leaves, args.vocab)
    model = TreeSentiment(args.vocab, args.hidden, args.leaves,
                          generator=seeded_generator()).to(device)
    toks = torch.from_numpy(tokens).to(device)
    y = torch.from_numpy(labels.astype(np.float32)).to(device)
    losses = train(model, toks, y, args.epochs, args.lr)
    with torch.no_grad():
        logits = model(toks).cpu().numpy()
    # TreeNNAccuracy scores the first (root) output column
    acc, n = TreeNNAccuracy()(logits[:, None, :],
                              np.asarray(labels)[:, None]).result()
    print(f"final loss {float(losses[-1]):.4f} TreeNNAccuracy {acc:.3f} "
          f"({n})")
    return acc


if __name__ == "__main__":
    main()
