"""Shared parity harness for the port's tests: trees carried between the
JAX package and the port, and :func:`assert_parity`, which holds a port
module to its JAX counterpart on the same parameters and input — the
outputs, and the gradients of one scalar loss with respect to the input
and to every parameter.

The trees are nested dicts, lists, tuples and Tables (either package's)
with array leaves; numpy is the wire format between the two."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bigdl_tpu.utils.table import Table as JaxTable
from bigdl_tpu_torch.convert import flatten_params
from bigdl_tpu_torch.utils.table import Table

__all__ = ["assert_criterion_parity", "assert_parity",
           "assert_table_parity", "assert_trees_close",
           "flat", "jax_eval", "to_jax", "to_numpy", "to_torch"]


def _map(fn, tree, table):
    if isinstance(tree, (Table, JaxTable)):
        return table({k: _map(fn, v, table) for k, v in tree.items()})
    if isinstance(tree, dict):
        return {k: _map(fn, v, table) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, e, table) for e in tree)
    return fn(tree)


def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def to_numpy(tree):
    """Leaves (torch tensors, JAX arrays, numbers) as numpy arrays; a
    Table of either package becomes the port's Table."""
    return _map(_np, tree, Table)


def to_torch(tree):
    """Leaves as CPU torch tensors (copies); Tables as the port's."""
    return _map(lambda a: torch.from_numpy(np.array(_np(a))), tree, Table)


def to_jax(tree):
    """Leaves as JAX arrays; Tables as the JAX package's."""
    return _map(lambda a: jnp.asarray(_np(a)), tree, JaxTable)


def flat(tree):
    """``{"a.b": numpy leaf}`` of a nested param tree (empty dicts, the
    JAX tree's parameterless layers, carry no leaf)."""
    return {k: _np(v) for k, v in flatten_params(tree).items()}


def jax_eval(ref, x):
    """``ref``'s (a JAX Module's) evaluation forward of ``x`` as one
    compiled program: op-by-op dispatch compiles each layer's shapes
    apart, seconds for a deep model."""
    fwd = jax.jit(lambda p, s, a: ref.apply(p, s, a, training=False)[0])
    return np.asarray(fwd(ref.get_parameters(), ref.get_state(),
                          jnp.asarray(x)))


def assert_trees_close(got, want, atol, rtol=0.0):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _floating(x):
    return np.issubdtype(np.asarray(x).dtype, np.floating)


def assert_parity(ref, port, input, atol, rtol=0.0, training=False,
                  seed=0, rng=None, jit=False):
    """Hold ``port`` (a port Module) to ``ref`` (the JAX Module).

    ``ref``'s parameters (initialised if needed) are carried into
    ``port`` with ``set_parameters``; both run ``input`` (numpy, or a
    list / Table of numpy) in evaluation mode unless ``training``
    (``rng``: the JAX apply's key, for a layer that needs one). The
    outputs must agree, and so must the gradients of
    ``sum(output * w)``, ``w`` seeded normal of the output's shape, with
    respect to the floating input and to every parameter: each within
    ``atol + rtol * |JAX value|``. With ``jit`` the JAX side runs as
    one compiled program (cheaper than op-by-op dispatch for a deep
    block). Returns the port's output."""
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    if flat(params):
        port.set_parameters(params)
    port.train(training)
    state = ref.get_state()

    def jax_out(p, x):
        return ref.apply(p, state, x, training=training, rng=rng)[0]

    compiled = jax.jit if jit else (lambda f: f)

    j_in = to_jax(input)
    j_params = jax.tree.map(jnp.asarray, params)
    want = np.asarray(compiled(jax_out)(j_params, j_in))
    w = np.random.RandomState(seed).standard_normal(want.shape) \
        .astype(np.float32)

    def j_loss(p, x):
        return jnp.sum(jax_out(p, x) * w)

    leaves = []
    _map(leaves.append, input, Table)
    grad_in = all(_floating(leaf) for leaf in leaves)
    if grad_in:
        j_gp, j_gx = compiled(jax.grad(j_loss, argnums=(0, 1)))(j_params,
                                                                 j_in)
    else:
        j_gp = compiled(jax.grad(j_loss))(j_params, j_in)

    x = to_torch(input)
    if grad_in:
        x = _map(lambda t: t.requires_grad_(), x, Table)
    for p in port.parameters():
        p.grad = None
    got = port(x)
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=rtol,
                               err_msg="output")
    loss = (got * torch.from_numpy(w)).sum()
    if loss.requires_grad:     # BinaryThreshold's output has no gradient
        loss.backward()
    if flat(params):
        assert_trees_close(port.get_grad_parameters(), j_gp, atol, rtol)
    if grad_in:
        g_x = _map(lambda t: t.grad if t.grad is not None
                   else torch.zeros_like(t), x, Table)
        for name, (g, j) in _pairs(g_x, j_gx).items():
            np.testing.assert_allclose(_np(g), np.asarray(j), atol=atol,
                                       rtol=rtol, err_msg=f"grad {name}")
    return got


def _pairs(port_tree, jax_tree, prefix="input"):
    """``{path: (port leaf, JAX leaf)}`` over the input's leaves."""
    if isinstance(port_tree, (Table, dict)):
        out = {}
        for k in port_tree.keys():
            out.update(_pairs(port_tree[k], jax_tree[k], f"{prefix}.{k}"))
        return out
    if isinstance(port_tree, (list, tuple)):
        out = {}
        for i, (p, j) in enumerate(zip(port_tree, jax_tree)):
            out.update(_pairs(p, j, f"{prefix}.{i}"))
        return out
    return {prefix: (port_tree, jax_tree)}


def _leaves(tree):
    """A table tree's leaves in order (lists, tuples, either package's
    Tables)."""
    if isinstance(tree, (Table, JaxTable, list, tuple)):
        return [leaf for e in tree for leaf in _leaves(e)]
    return [tree]


def _build(struct, leaves, table):
    """``struct``'s shape (lists and port Tables) over ``leaves``, its
    Tables built with ``table`` (either package's ``T``)."""
    it = iter(leaves)

    def rec(s):
        if isinstance(s, Table):
            return table(*[rec(e) for e in s])
        if isinstance(s, (list, tuple)):
            return [rec(e) for e in s]
        return next(it)

    return rec(struct)


def assert_table_parity(ref, port, inp, atol, rtol=None, jit=True,
                        grad=True, seed=7):
    """:func:`assert_parity` for table inputs and outputs: ``inp`` is
    numpy leaves in lists and port Tables (integer leaves allowed).
    The port's parameters are carried into ``ref``; every output leaf
    must agree (integer outputs exactly) and, with ``grad``, so must the
    gradients of ``sum_i out_i * w_i`` (``w_i`` seeded normal) with
    respect to every floating input leaf and every parameter, each
    within ``atol + rtol * |JAX value|`` (``rtol`` defaults to
    ``atol``). ``jit=False`` runs the JAX side eagerly (a layer whose
    output size is the data's). Returns the port's output leaves."""
    from bigdl_tpu.utils.table import T as JT
    from bigdl_tpu_torch.utils.table import T as PT

    rtol = atol if rtol is None else rtol
    if list(port.parameters()):
        ref.set_parameters(to_jax(port.get_parameters()))
    ref.ensure_initialized()
    params, state = ref.get_parameters(), ref.get_state()
    leaves = _leaves(inp)
    fl = [i for i, a in enumerate(leaves) if _floating(a)] if grad else []

    def jfwd(p, fls):
        ls = [jnp.asarray(a) for a in leaves]
        for i, v in zip(fl, fls):
            ls[i] = v
        return _leaves(ref.apply(p, state, _build(inp, ls, JT))[0])

    compiled = jax.jit if jit else (lambda f: f)
    fls = [jnp.asarray(leaves[i]) for i in fl]
    want = [np.asarray(o) for o in compiled(jfwd)(params, fls)]
    rng = np.random.RandomState(seed)
    ws = [rng.standard_normal(o.shape).astype(o.dtype)
          if _floating(o) else None for o in want]

    x = [torch.from_numpy(np.array(a)) for a in leaves]
    for i in fl:
        x[i].requires_grad_()
    got = _leaves(port(_build(inp, x, PT)))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, (k, tuple(g.shape), w.shape)
        if _floating(w):
            np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol,
                                       err_msg=f"output {k}")
        else:
            np.testing.assert_array_equal(_np(g), w, err_msg=f"output {k}")
    if not fl and not list(port.parameters()) or all(
            w is None for w in ws) or not grad:
        return got

    def jloss(p, fls):
        return sum(jnp.sum(o * w) for o, w in zip(jfwd(p, fls), ws)
                   if w is not None)

    gp, gx = compiled(jax.grad(jloss, argnums=(0, 1)))(params, fls)
    for p in port.parameters():
        p.grad = None
    loss = sum((g * torch.from_numpy(w)).sum()
               for g, w in zip(got, ws) if w is not None)
    if loss.requires_grad:
        loss.backward()
    if flat(params):
        assert_trees_close(port.get_grad_parameters(), gp, atol, rtol)
    for i, g in zip(fl, gx):
        t = x[i].grad if x[i].grad is not None else torch.zeros_like(x[i])
        np.testing.assert_allclose(_np(t), np.asarray(g), atol=atol,
                                   rtol=rtol, err_msg=f"grad input {i}")
    return got


def assert_criterion_parity(ref, port, inp, target, atol, rtol=None,
                            jit=True):
    """Hold a port criterion to its JAX twin: ``inp`` is numpy leaves in
    lists and port Tables, ``target`` the same or None. The losses
    must agree, and so must their gradients with respect to every
    floating input leaf, each within ``atol + rtol * |JAX value|``
    (``rtol`` defaults to ``atol``). Returns the port's loss."""
    from bigdl_tpu.utils.table import T as JT
    from bigdl_tpu_torch.utils.table import T as PT

    rtol = atol if rtol is None else rtol
    leaves = _leaves(inp)
    fl = [i for i, a in enumerate(leaves) if _floating(a)]
    j_target = None if target is None else to_jax(target)

    def jloss(fls):
        ls = [jnp.asarray(a) for a in leaves]
        for i, v in zip(fl, fls):
            ls[i] = v
        return ref.apply(_build(inp, ls, JT), j_target)

    compiled = jax.jit if jit else (lambda f: f)
    fls = [jnp.asarray(leaves[i]) for i in fl]
    want, grads = compiled(jax.value_and_grad(jloss))(fls)
    x = [torch.from_numpy(np.array(a)) for a in leaves]
    for i in fl:
        x[i].requires_grad_()
    got = port(_build(inp, x, PT),
               None if target is None else to_torch(target))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg="loss")
    if got.requires_grad:
        got.backward()
    for i, g in zip(fl, grads):
        t = x[i].grad if x[i].grad is not None else torch.zeros_like(x[i])
        np.testing.assert_allclose(_np(t), np.asarray(g), atol=atol,
                                   rtol=rtol, err_msg=f"grad input {i}")
    return got
