"""The port's paged decode attention (K4) against the JAX package's
Pallas kernel (run in interpret mode on the CPU) on the same seeded
inputs, identity and shuffled page tables, and against the port's
ragged decode (K3).

Tolerance: float32 atol 1e-5 against JAX — the JAX kernel contract's
decode row; the two take their sums in another order (torch einsum vs
the Pallas interpreter's dot_general). Against K3's plain version at
``page == block_k``: bitwise, since the plain versions run the same
tile recurrence over the same rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels.paged_decode import \
    paged_decode_attention as jax_paged
from bigdl_tpu.kernels.paged_decode import paged_view as jax_paged_view
from bigdl_tpu_torch import kernels, telemetry
from bigdl_tpu_torch.kernels import dispatch
from bigdl_tpu_torch.kernels.paged_decode import (
    cuda_unsupported, paged_decode_attention,
    paged_decode_attention_reference, paged_view)
from bigdl_tpu_torch.kernels.ragged_decode import \
    ragged_decode_attention_reference

SLOTS, H, T, D = 3, 2, 32, 16
ATOL = 1e-5

_jax_kernel = jax.jit(lambda *a: jax_paged(*a, interpret=True))


def _inputs(seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((SLOTS, H, D)).astype(np.float32)
    k = r.standard_normal((SLOTS, H, T, D)).astype(np.float32)
    v = r.standard_normal((SLOTS, H, T, D)).astype(np.float32)
    return q, k, v


def _shuffled(k_pages, v_pages, table, seed):
    """The same view with the pool's pages permuted and the table
    renumbered to follow them."""
    perm = np.random.default_rng(seed).permutation(k_pages.shape[0])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return k_pages[inv], v_pages[inv], perm[table].astype(np.int32)


@pytest.mark.parametrize("page", [4, 8, 16])
@pytest.mark.parametrize("shuffle", [False, True])
def test_plain_version_matches_jax_kernel(page, shuffle):
    q, k, v = _inputs(seed=page)
    kp, vp, table = (np.asarray(a) for a in
                     jax_paged_view(jnp.asarray(k), jnp.asarray(v), page))
    if shuffle:
        kp, vp, table = _shuffled(kp, vp, table, seed=page + 1)
    for lengths in ([1, 17, 32], [page, page + 1, 0], [40, 5, 31]):
        lengths = np.asarray(lengths, np.int32)
        want = np.asarray(_jax_kernel(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lengths)))
        got = paged_decode_attention(
            *(torch.from_numpy(np.array(a)) for a in
              (q, kp, vp, table, lengths))).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"lengths {lengths}")


def test_paged_view_equals_jax_paged_view():
    q, k, v = _inputs(seed=1)
    want = jax_paged_view(jnp.asarray(k), jnp.asarray(v), 8)
    got = paged_view(torch.from_numpy(k), torch.from_numpy(v), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        paged_view(torch.from_numpy(k), torch.from_numpy(v), 5)


@pytest.mark.parametrize("shuffle", [False, True])
def test_plain_version_bitwise_k3_plain_at_page_equal_block_k(shuffle):
    q, k, v = _inputs(seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kp, vp, table = paged_view(tk, tv, 8)
    if shuffle:
        kp, vp, table = (torch.from_numpy(np.array(a)) for a in _shuffled(
            kp.numpy(), vp.numpy(), table.numpy(), seed=9))
    for lengths in ([1, 8, 9], [32, 0, 24], [17, 31, 100]):
        lengths = torch.tensor(lengths, dtype=torch.int32)
        paged = paged_decode_attention_reference(q=tq, k_pages=kp,
                                                 v_pages=vp,
                                                 page_table=table,
                                                 lengths=lengths)
        ragged = ragged_decode_attention_reference(tq, tk, tv, lengths,
                                                   block_k=8)
        assert torch.equal(paged, ragged), f"lengths {lengths.tolist()}"


def test_pages_past_the_length_are_never_trusted():
    """Table entries past a slot's valid pages may hold anything; pages
    a slot does not own may hold non-finite garbage."""
    q, k, v = _inputs(seed=11)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kp, vp, table = paged_view(tk, tv, 8)
    lengths = torch.tensor([5, 9, 32], dtype=torch.int32)
    want = paged_decode_attention(tq, kp, vp, table, lengths)
    table2 = table.clone()
    table2[0, 1:] = 10_000         # slot 0 reads page 0 only
    table2[1, 2:] = -7             # slot 1 reads pages 0..1
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[table[0, 1:]] = float("nan")
    vp2[table[0, 1:]] = float("inf")
    got = paged_decode_attention(tq, kp2, vp2, table2, lengths)
    torch.testing.assert_close(got[:2], want[:2], rtol=0, atol=0)


def test_dispatch_declines_and_counts():
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=3))
    kp, vp, table = paged_view(k, v, 8)
    lengths = torch.tensor([3, 20, 32], dtype=torch.int32)
    taken = telemetry.counter("kernels/dispatch/kernel")
    ref = telemetry.counter("kernels/dispatch/reference")
    t0 = taken.value(op="decode")
    c0 = ref.value(op="decode", reason="config")
    s0 = ref.value(op="decode", reason="shape")
    launches = paged_decode_attention.launches
    with kernels.use(kernels.KernelConfig.ported()):
        out = kernels.paged_decode_attention(q, kp, vp, table, lengths)
        torch.testing.assert_close(
            out, paged_decode_attention_reference(q, kp, vp, table,
                                                  lengths), rtol=0, atol=0)
        # shape declines: q heads, pool shapes, table rows, dtype
        assert kernels.paged_decode_attention(q[:, :1], kp, vp, table,
                                              lengths) is None
        assert kernels.paged_decode_attention(q, kp, vp[:, :, :4], table,
                                              lengths) is None
        assert kernels.paged_decode_attention(q, kp, vp, table[:2],
                                              lengths) is None
        assert kernels.paged_decode_attention(
            q.long(), kp.long(), vp.long(), table, lengths) is None
    with kernels.use(kernels.KernelConfig.off()):
        assert kernels.paged_decode_attention(q, kp, vp, table,
                                              lengths) is None
    assert taken.value(op="decode") == t0 + 1
    assert ref.value(op="decode", reason="shape") == s0 + 4
    assert ref.value(op="decode", reason="config") == c0 + 1
    assert paged_decode_attention.launches == launches


class _OnCard:
    """Stands in for a CUDA tensor: routing reads only its shape, dtype,
    device and strides."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda")

    def stride(self, dim=None):
        return 1

    def is_contiguous(self):
        return True


@pytest.mark.parametrize("d,dtype,takes", [
    (64, torch.float32, True), (128, torch.bfloat16, True),
    (48, torch.float32, False), (64, torch.float16, False)])
def test_cuda_operands_the_kernel_does_not_take(d, dtype, takes):
    q = _OnCard((4, 8, d), dtype)
    pools = _OnCard((32, 8, 16, d), dtype)
    table = _OnCard((4, 8), torch.int32)
    lengths = _OnCard((4,), torch.int32)
    why = cuda_unsupported(q, pools, pools, table, lengths)
    assert (why is None) == takes
    if not takes:
        with kernels.use(kernels.KernelConfig.ported()):
            with pytest.raises(ValueError, match="paged_decode kernel"):
                dispatch.paged_decode_attention(q, pools, pools, table,
                                                lengths)


def test_cuda_shape_decline_raises():
    q = _OnCard((4, 8, 64), torch.float32)
    pools = _OnCard((32, 4, 16, 64), torch.float32)   # heads differ
    with kernels.use(kernels.KernelConfig.ported()):
        with pytest.raises(ValueError, match="paged decode takes"):
            dispatch.paged_decode_attention(
                q, pools, pools, _OnCard((4, 8), torch.int32),
                _OnCard((4,), torch.int32))
