"""Sequence parallelism on ``torch.distributed`` (ring and Ulysses)
against the JAX package: one gang of 4 gloo ranks on the CPU
(``_torch_dist_cases.attention`` and ``.data_by_seq``), the JAX side on
4 of the conftest's virtual CPU devices.

- ring and Ulysses over ``seq`` = 4: each rank's slice of the output and
  of the input gradients of ``sum(out * g)``, causal and not, with and
  without packed segments, within 1e-5 of ``ring_attention_sharded`` /
  ``ulysses_attention_sharded`` (the shapes of tests/test_parallel.py);
  the port's whole-array wrappers equal them too;
- a module without ``ring_axis`` adopts the installed policy;
- Ulysses refuses heads that do not divide the axis;
- the ring's backward without its last hop comes out wrong;
- a data = 2 x seq = 2 training run at ZeRO stage 2, ring and Ulysses,
  within 1e-5 of the JAX package's mesh run (a factor of 2 off in the
  gradient's sum over seq or mean over data fails at once);
- uneven ``ignore_index`` padding over 4 seq ranks: the loss is the
  global token mean, the JAX package's dense run's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from bigdl_tpu.parallel import (ring_attention_sharded,
                                ulysses_attention_sharded)

import _torch_dist_cases as cases
from _torch_gang import run_gang
from test_torch_distributed import _assert_params, _jax_run

SHAPE = (2, 4, 64, 16)       # B, H, S, D
SEG_LEN = 8
ATOL = 1e-5
WORLD = 4


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    att = run_gang(cases.attention, WORLD, tmp, SHAPE, SEG_LEN)
    train = run_gang(cases.data_by_seq, WORLD, tmp, timeout=300)
    return att, train


def _jax_attention(impl, causal, packed):
    q, k, v, g = cases._qkv(SHAPE, 0)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("seq",))
    fn = ring_attention_sharded if impl == "ring" \
        else ulysses_attention_sharded
    b, _, s, _ = SHAPE
    seg = None
    if packed:
        seg = jnp.asarray(np.repeat(np.arange(s // SEG_LEN), SEG_LEN)[None]
                          .repeat(b, 0).astype(np.int32) + 1)

    def f(q, k, v):
        return fn(q, k, v, mesh, causal=causal, segments=seg)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(t)
                                for t in vjp(jnp.asarray(g))]


def _gathered(att, key):
    return [np.concatenate([att[r][key][i] for r in range(WORLD)], axis=2)
            for i in range(4)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_and_input_gradients_match_jax(gang, impl, causal,
                                                 packed):
    att, _ = gang
    got = _gathered(att, (impl, causal, packed))
    want = _jax_attention(impl, causal, packed)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0,
                                   err_msg=f"{impl} {name}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_whole_array_wrappers(gang, impl):
    att, _ = gang
    want = _jax_attention(impl, True, False)[0]
    for r in range(WORLD):
        np.testing.assert_allclose(att[r][f"{impl}_sharded"], want,
                                   atol=ATOL, rtol=0)


def test_a_module_without_ring_axis_adopts_the_policy(gang):
    att, _ = gang
    for r in range(WORLD):
        adopted, dense = att[r]["adopted"]
        np.testing.assert_allclose(adopted, dense, atol=ATOL, rtol=0)


def test_ulysses_refuses_heads_that_do_not_divide(gang):
    att, _ = gang
    assert "ulysses needs heads (1) divisible by the 'seq' mesh size (4)" \
        in att[0]["indivisible"]


def test_the_ring_backward_needs_its_last_hop(gang):
    att, _ = gang
    _, dk, dv = [np.concatenate([att[r]["no_last_hop"][i]
                                 for r in range(WORLD)], axis=2)
                 for i in range(3)]
    want = _jax_attention("ring", True, False)
    assert np.abs(dk - want[2]).max() > 1e-2
    assert np.abs(dv - want[3]).max() > 1e-2


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_data_by_seq_stage2_matches_the_jax_mesh_run(gang, impl):
    _, train = gang
    x, y = cases.contiguous_rows()
    want_losses, want_params = _jax_run(
        x, y, stage=2, mesh_sizes=(2, 2), mesh_names=("data", "seq"),
        seq_parallel=impl)
    for r in range(WORLD):
        got = train[r][impl]
        np.testing.assert_allclose(got["losses"], want_losses, atol=ATOL,
                                   rtol=0)
        _assert_params(got["params"], want_params, ATOL,
                       msg=f"rank {r} {impl}")


def test_uneven_padding_over_seq_ranks_gives_the_global_token_mean(gang):
    _, train = gang
    x, y = cases.contiguous_rows()
    py = y.copy()
    py[:, : cases.LM["max_len"] // 2 - 2] = -1
    want_losses, want_params = _jax_run(x, py, steps=2, local=True)
    got = train[0]["padded"]
    np.testing.assert_allclose(got["losses"], want_losses, atol=ATOL,
                               rtol=0)
    _assert_params(got["params"], want_params, ATOL, msg="padded")
