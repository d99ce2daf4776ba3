"""The tree-LSTM family and ``TreeNNAccuracy`` of the port against the
JAX package (``bigdl_tpu/nn/tree_lstm.py``, ``optim/validation.py``):
``BinaryTreeLSTM``'s per-node hidden states and the gradients of a
seeded scalar loss with respect to the embeddings and the four
parameters, on a full tree, an unbalanced tree, one leaf, and tables
the JAX scan reads oddly (a missing right child, a child read before it
is computed), with and without the output gate; the batched call
against the JAX example's ``vmap``; the children as a tensor; saved
modules across packages; ``TreeNNAccuracy`` on 3-d, 2-d and 1-wide
outputs.

The port's weights are carried into the JAX module and the JAX side runs
jitted. Tolerance (float32): 1e-5 absolute and relative, outputs and
gradients; accuracies exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.examples.tree_lstm_sentiment import build_full_tree
from bigdl_tpu_torch.utils import module_serializer as ms
from bigdl_tpu_torch.utils import serialization as ser

from _torch_parity import assert_table_parity, to_jax

TOL = 1e-5
I, H = 5, 6

torch.set_num_threads(1)

TREES = {
    "full-8": build_full_tree(8),
    "full-5": build_full_tree(5),                    # an odd frontier
    "unbalanced": np.array([[-1, -1], [-1, -1], [-1, -1], [-1, -1],
                            [0, 1], [4, 2], [5, 3]], np.int32),
    "one-leaf": np.array([[-1, -1]], np.int32),
    "missing-right": np.array([[-1, -1], [-1, -1], [0, -1], [2, 1]],
                              np.int32),
    "read-before-computed": np.array([[-1, -1], [3, 0], [-1, -1], [1, 2]],
                                     np.int32),
}


def _emb(n, seed=0, batch=()):
    return np.random.default_rng(seed).standard_normal(
        batch + (n, I)).astype(np.float32)


def _pair(gate_output=True, seed=3):
    port = nn.BinaryTreeLSTM(I, H, gate_output,
                             generator=torch.Generator().manual_seed(seed))
    ref = jnn.BinaryTreeLSTM(I, H, gate_output)
    return ref, port


@pytest.mark.parametrize("gate_output", [True, False])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_binary_tree_lstm_equals_jax(tree, gate_output):
    children = TREES[tree]
    ref, port = _pair(gate_output)
    out = assert_table_parity(ref, port, [_emb(len(children)), children],
                              TOL)
    assert tuple(out[0].shape) == (len(children), H)


def test_parameters_and_init_match_the_jax_layout():
    port = nn.BinaryTreeLSTM(I, H)
    ref = jnn.BinaryTreeLSTM(I, H)
    ref.ensure_initialized()
    got, want = port.get_parameters(), ref.get_parameters()
    assert sorted(got) == sorted(want) == ["b_comp", "b_leaf", "w_comp",
                                           "w_leaf"]
    for k in got:
        assert got[k].shape == np.asarray(want[k]).shape
    bound = 1.0 / np.sqrt(H)
    assert np.abs(got["w_comp"]).max() <= bound
    assert not got["b_leaf"].any() and not got["b_comp"].any()
    assert isinstance(nn.TreeLSTM(I, H), nn.BinaryTreeLSTM)


def test_batched_call_equals_the_jax_vmap():
    """``[B, n, I]`` embeddings over one children table: the rows of the
    JAX example's ``jax.vmap`` of the one-tree forward, and their
    gradients."""
    children = TREES["full-8"]
    ref, port = _pair(seed=5)
    ref.set_parameters(to_jax(port.get_parameters()))
    emb = _emb(len(children), seed=2, batch=(4,))
    w = np.random.RandomState(1).standard_normal((4, len(children), H)) \
        .astype(np.float32)

    def j_loss(p, e):
        hs = jax.vmap(lambda one: ref.forward_fn(p, [one, children]))(e)
        return jnp.sum(hs * w), hs

    (_, want), (gp, ge) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(ref.get_parameters(),
                                               jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_()
    got = port([x, children])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ge), atol=TOL,
                               rtol=TOL)
    for k, v in port.get_grad_parameters().items():
        np.testing.assert_allclose(v, np.asarray(gp[k]), atol=TOL, rtol=TOL,
                                   err_msg=k)


def test_children_as_a_tensor_and_a_table_input():
    """A children tensor (read on the host once) and a Table input give
    the same states as host numpy children in a list."""
    from bigdl_tpu_torch.utils.table import T
    children = TREES["unbalanced"]
    _, port = _pair()
    emb = torch.from_numpy(_emb(len(children)))
    with torch.no_grad():
        want = port([emb, children])
        assert torch.equal(port(T(emb, torch.from_numpy(children))), want)


def test_root_through_select_and_spec_round_trip():
    """``Select(1, -1)`` takes the root; the spec is the JAX package's."""
    import json

    from bigdl_tpu.utils import module_serializer as jms
    seq = nn.Sequential().add(nn.BinaryTreeLSTM(I, H, False)) \
        .add(nn.Select(1, -1))
    jseq = jnn.Sequential().add(jnn.BinaryTreeLSTM(I, H, False)) \
        .add(jnn.Select(1, -1))
    children = TREES["full-5"]
    out = assert_table_parity(jseq, seq, [_emb(len(children)), children],
                              TOL)
    assert tuple(out[0].shape) == (H,)
    spec = ms.to_spec(seq)
    assert spec == json.loads(json.dumps(jms.to_spec(jseq)))
    assert ms.to_spec(ms.from_spec(spec)) == spec


def test_saved_tree_lstm_loads_across_packages(tmp_path):
    children = TREES["full-8"]
    emb = _emb(len(children), seed=4)
    ref, port = _pair(seed=8)
    with torch.no_grad():
        want = port([torch.from_numpy(emb), children]).numpy()
    ser.save_module(str(tmp_path / "port"), port)
    loaded = jser.load_module(str(tmp_path / "port"))
    np.testing.assert_allclose(
        np.asarray(loaded.forward([emb, children])), want, atol=TOL,
        rtol=TOL)
    ref.set_parameters(to_jax(port.get_parameters()))
    jser.save_module(str(tmp_path / "jax"), ref)
    back = ser.load_module(str(tmp_path / "jax"), device="cpu")
    assert type(back).__name__ == "BinaryTreeLSTM"
    with torch.no_grad():
        np.testing.assert_allclose(
            back([torch.from_numpy(emb), children]).numpy(), want,
            atol=TOL, rtol=TOL)


# ------------------------------------------------------- TreeNNAccuracy

def _scores(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


ACC_CASES = {
    "3-d": (_scores((6, 4, 3), 1),
            np.random.RandomState(2).randint(1, 4, (6, 4)).astype(
                np.float32)),
    "2-d": (_scores((4, 3), 3), np.array([2, 1, 3, 1], np.float32)),
    "1-wide-3d": (np.random.RandomState(4).uniform(0, 1, (8, 3, 1))
                  .astype(np.float32),
                  np.random.RandomState(5).randint(0, 2, (8, 3)).astype(
                      np.float32)),
    "1-wide-2d": (np.array([[0.5], [0.2]], np.float32),
                  np.array([1, 0], np.float32)),
    "1-wide-threshold": (np.array([[[0.49]], [[0.5]], [[0.51]]],
                                  np.float32),
                         np.array([[0], [1], [0]], np.float32)),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_tree_nn_accuracy_equals_jax(case):
    out, tgt = ACC_CASES[case]
    got = optim.TreeNNAccuracy()(out, tgt)
    want = joptim.TreeNNAccuracy()(out, tgt)
    assert got.result() == want.result()
    assert (got + got).result() == (want + want).result()
    assert optim.TreeNNAccuracy.name == "TreeNNAccuracy"


def test_tree_nn_accuracy_refuses_1d_output_in_both():
    for m in (optim.TreeNNAccuracy(), joptim.TreeNNAccuracy()):
        with pytest.raises(ValueError, match="2-d or 3-d"):
            m(np.zeros(3, np.float32), np.zeros(3, np.float32))
