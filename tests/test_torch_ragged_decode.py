"""The port's ragged decode attention against the JAX package's Pallas
kernel (run in interpret mode on the CPU) on the same seeded inputs.

Tolerance: float32 atol 1e-5 — the JAX kernel contract's row; the two
take their sums in another order (torch einsum vs the Pallas
interpreter's dot_general), nothing else differs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kernels as jax_kernels
from bigdl_tpu import telemetry as jax_telemetry
from bigdl_tpu.kernels.ragged_decode import \
    ragged_decode_attention as jax_ragged_decode
from bigdl_tpu_torch import kernels, telemetry
from bigdl_tpu_torch.kernels import decode_attention
from bigdl_tpu_torch.kernels.paged_decode import paged_plan, paged_view
from bigdl_tpu_torch.kernels.ragged_decode import (
    decode_plan, ragged_decode_attention, ragged_decode_attention_reference,
    stage_keys)

SLOTS, H, T, D, BLOCK_K = 3, 2, 32, 16, 8
ATOL = 1e-5

# lengths ride in as data, so one trace serves every case
_jax_kernel = jax.jit(functools.partial(jax_ragged_decode, block_k=BLOCK_K,
                                        interpret=True))


def _inputs(seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((SLOTS, H, D)).astype(np.float32)
    k = r.standard_normal((SLOTS, H, T, D)).astype(np.float32)
    v = r.standard_normal((SLOTS, H, T, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, lengths):
    lengths = np.asarray(lengths, np.int32)
    want = np.asarray(_jax_kernel(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(lengths)))
    got = ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), block_k=BLOCK_K).numpy()
    return got, want


@pytest.mark.parametrize("first", [1, 9, 17, 25])
def test_every_length_matches_jax_kernel(first):
    """Every length 1..T appears in every slot position (block edges
    8/16/24 and T itself included), eight lengths per case."""
    q, k, v = _inputs(seed=first)
    for n in range(first, first + 8):
        lengths = [n, T + 1 - n, (7 * n) % T + 1]
        got, want = _both(q, k, v, lengths)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"lengths {lengths}")


def test_mixed_and_clamped_lengths_match_jax_kernel():
    """Lengths 0 and > T clamp into [1, T] on both sides."""
    q, k, v = _inputs(seed=3)
    for lengths in ([0, 5, 32], [33, 1, 100], [-4, 16, 31]):
        got, want = _both(q, k, v, lengths)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"lengths {lengths}")
    clamped, _ = _both(q, k, v, [1, 1, 32])
    got, _ = _both(q, k, v, [0, -3, 99])
    np.testing.assert_array_equal(got, clamped)


def test_cache_view_read_in_place_matches_contiguous():
    """A ``[:, :, :T]`` view of a longer cache (what the decode step
    passes) gives exactly the contiguous result."""
    q, k, v = _inputs(seed=4)
    big_k = np.concatenate([k, np.full_like(k, 1e6)], axis=2)
    big_v = np.concatenate([v, np.full_like(v, 1e6)], axis=2)
    lengths = torch.tensor([3, 32, 17], dtype=torch.int32)
    tk, tv = torch.from_numpy(big_k), torch.from_numpy(big_v)
    view = ragged_decode_attention(torch.from_numpy(q), tk[:, :, :T],
                                   tv[:, :, :T], lengths)
    dense = ragged_decode_attention(torch.from_numpy(q),
                                    torch.from_numpy(k),
                                    torch.from_numpy(v), lengths)
    torch.testing.assert_close(view, dense, rtol=0, atol=0)


def test_cpu_call_runs_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=5))
    lengths = torch.tensor([4, 20, 32], dtype=torch.int32)
    before = ragged_decode_attention.launches
    out = decode_attention(q, k, v, lengths)
    assert ragged_decode_attention.launches == before
    torch.testing.assert_close(
        out, ragged_decode_attention_reference(q, k, v, lengths),
        rtol=0, atol=0)


def test_dispatch_rejects_what_the_kernel_does_not_take():
    """What the JAX package's kernel fails on too raises on every device,
    counted reason=shape: v not of k's shape, lengths not [slots]; and
    the wrapper runs on cuda or cpu only."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=6))
    lengths = torch.ones(SLOTS, dtype=torch.int32)
    ref = telemetry.counter("kernels/dispatch/reference")
    s0 = ref.value(op="decode", reason="shape")
    with kernels.use(kernels.KernelConfig.ported()):
        with pytest.raises(ValueError):
            decode_attention(q, k, v[:, :, :8], lengths)       # k/v shapes
        with pytest.raises(ValueError):
            decode_attention(q, k, v, lengths[:2])             # lengths
    assert ref.value(op="decode", reason="shape") == s0 + 2
    with pytest.raises(ValueError):                        # no such device
        ragged_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                lengths.to("meta"))


def _jax_dtype(x):
    return {torch.float32: jnp.float32, torch.float16: jnp.float16,
            torch.bfloat16: jnp.bfloat16, torch.int32: jnp.int32}[x.dtype]


#: operands the JAX dispatch declines (k not of rank 4, q not k's shape
#: without T, a dtype that is not floating) and ones it takes (mixed
#: floating dtypes included: its kernel computes in float32)
_DISPATCH_CASES = {
    "takes": lambda q, k, v: (q, k, v),
    "k of rank 3": lambda q, k, v: (q, k[0], v[0]),
    "q heads differ": lambda q, k, v: (q[:, :1], k, v),
    "q of rank 2": lambda q, k, v: (q[0], k, v),
    "q head_dim differs": lambda q, k, v: (q[..., :8], k, v),
    "q not floating": lambda q, k, v: ((q * 8).to(torch.int32), k, v),
    "k not floating": lambda q, k, v: (q, (k * 8).to(torch.int32), v),
    "v not floating": lambda q, k, v: (q, k, (v * 8).to(torch.int32)),
    "float16 q, float32 cache": lambda q, k, v: (q.half(), k, v),
    "float32 q, bfloat16 k": lambda q, k, v: (q, k.bfloat16(), v),
}


@pytest.mark.parametrize("case", list(_DISPATCH_CASES))
def test_dispatch_declines_as_the_jax_package_does(case):
    """On the CPU the port's decode dispatch returns None (the caller's
    einsum path runs) exactly where the JAX package's does, counting the
    same reason=shape declines, and otherwise agrees with it."""
    base = (torch.from_numpy(a) for a in _inputs(seed=12))
    q, k, v = _DISPATCH_CASES[case](*base)
    lengths = torch.tensor([3, 32, 17], dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(_jax_dtype(x))
                  for x in (q, k, v))
    jax_ref = jax_telemetry.counter("kernels/dispatch/reference")
    ref = telemetry.counter("kernels/dispatch/reference")
    j0, p0 = (jax_ref.value(op="decode", reason="shape"),
              ref.value(op="decode", reason="shape"))
    with jax_kernels.use(jax_kernels.KernelConfig(
            decode_attention=True, interpret=True, block_k=BLOCK_K)):
        want = jax_kernels.decode_attention(jq, jk, jv,
                                            jnp.asarray(lengths.numpy()))
    with kernels.use(kernels.KernelConfig.ported(block_k=BLOCK_K)):
        got = decode_attention(q, k, v, lengths)
    assert (jax_ref.value(op="decode", reason="shape") - j0
            == ref.value(op="decode", reason="shape") - p0)
    assert (got is None) == (want is None), case
    if got is not None:
        assert got.dtype == q.dtype and want.dtype == jq.dtype
        atol = ATOL if q.dtype == torch.float32 else 1e-3
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=0)


def test_stage_keys_mirror_the_kernel_tile():
    """8 KB of one tensor's rows at the head-dim tile (32, 64, 128, 256),
    at most 64 keys (``csrc/decode_common.cuh`` Tile::SK)."""
    assert [stage_keys(d, 4) for d in (1, 20, 32, 48, 64, 100, 128, 256)] \
        == [64, 64, 64, 32, 32, 16, 16, 8]
    assert [stage_keys(d, 2) for d in (20, 48, 64, 128, 256)] \
        == [64, 64, 64, 32, 16]


@pytest.mark.parametrize("t_len", [1, 17, 64, 65, 128, 512, 1000, 8192,
                                   32768])
def test_decode_plan_covers_the_keys_and_fills_the_card(t_len):
    """Whole stages of at least 64 keys; the splits cover [0, t_len)
    exactly; at most 64 splits; slots x heads x splits >= 4 x sms unless
    the chunk is already the shortest (64 keys) or the cap binds."""
    for slots, heads, d, itemsize, sms in (
            (16, 8, 64, 4, 132), (1, 8, 64, 4, 132), (4, 8, 64, 4, 132),
            (3, 2, 20, 2, 132), (64, 32, 128, 2, 132), (1, 1, 256, 4, 8),
            (16, 8, 48, 2, 1), (1, 1, 64, 4, 132)):
        plan = decode_plan(slots, heads, t_len, d, itemsize, sms)
        sk = stage_keys(d, itemsize)
        assert plan.stage_keys == sk
        assert plan.chunk % sk == 0 and plan.chunk >= 64
        assert (plan.splits - 1) * plan.chunk < t_len <= \
            plan.splits * plan.chunk
        assert 1 <= plan.splits <= 64
        assert plan.grid == (slots, heads, plan.splits)
        capped = plan.chunk == -(-(-(-t_len // 64)) // sk) * sk
        assert (slots * heads * plan.splits >= 4 * sms
                or plan.chunk == 64 or capped), (slots, heads, d, plan)


def test_decode_plan_at_the_serving_and_long_context_shapes():
    assert decode_plan(16, 8, 512, 64, 4, 132)[:3] == (32, 64, 8)
    assert decode_plan(1, 8, 8192, 64, 4, 132)[:3] == (32, 128, 64)


@pytest.mark.parametrize("page", [1, 7, 16, 64, 128])
def test_paged_plan_is_k3_plan_at_pages_times_page_size(page):
    """K4 plans as K3 at t_len = pages_per_slot * page_size, so its keys
    split as K3's on every paged view of the same cache."""
    t = 7 * 128
    q = torch.zeros(4, 8, 64)
    k = torch.zeros(4, 8, t, 64)
    kp, _, table = paged_view(k, k, page)
    for sms in (1, 8, 132):
        assert paged_plan(q, kp, table, sms) == decode_plan(4, 8, t, 64, 4,
                                                            sms)


class _OnCard:
    """Stands in for a CUDA tensor: the decode dispatch reads only its
    shape, dtype, device and strides before it would launch, so the
    card's refusals are checked without a card."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda", 0)

    def stride(self, dim=None):
        st = torch.empty(self.shape, device="meta").stride()
        return st if dim is None else st[dim]


@pytest.mark.parametrize("dtype,d,len_dtype", [
    (torch.float64, 64, torch.int32),     # a dtype K3 is not built for
    (torch.float32, 264, torch.int32),    # head_dim past 256
    (torch.float32, 64, torch.int64)])    # lengths not int32
def test_cuda_operands_the_kernel_does_not_take_raise_as_shape(dtype, d,
                                                                len_dtype):
    """CUDA operands K3 does not take are a reason=shape decline that
    raises, and are never counted as a kernel call (as the flash, paged
    and int8 routes count them)."""
    from bigdl_tpu_torch.kernels.ragged_decode import cuda_unsupported
    q = _OnCard((SLOTS, H, d), dtype)
    k = _OnCard((SLOTS, H, T, d), dtype)
    lengths = _OnCard((SLOTS,), len_dtype)
    assert cuda_unsupported(q, k, k, lengths) is not None
    assert cuda_unsupported(_OnCard((SLOTS, H, 64), torch.float32),
                            _OnCard((SLOTS, H, T, 64), torch.float32),
                            _OnCard((SLOTS, H, T, 64), torch.float32),
                            _OnCard((SLOTS,), torch.int32)) is None
    ref = telemetry.counter("kernels/dispatch/reference")
    taken = telemetry.counter("kernels/dispatch/kernel")
    s0, t0 = ref.value(op="decode", reason="shape"), taken.value(op="decode")
    launches = ragged_decode_attention.launches
    with kernels.use(kernels.KernelConfig.ported()):
        with pytest.raises(ValueError, match="ragged_decode kernel"):
            decode_attention(q, k, k, lengths)
    assert ref.value(op="decode", reason="shape") == s0 + 1
    assert taken.value(op="decode") == t0
    assert ragged_decode_attention.launches == launches


@pytest.mark.parametrize("dtype,d", [
    (torch.float16, 64), (torch.float32, 48), (torch.bfloat16, 20),
    (torch.float32, 256), (torch.float16, 1), (torch.bfloat16, 128)])
def test_cuda_operands_the_kernel_takes(dtype, d):
    """float32, bfloat16 and float16 of one dtype, any head_dim 1-256."""
    from bigdl_tpu_torch.kernels.ragged_decode import cuda_unsupported
    assert cuda_unsupported(_OnCard((SLOTS, H, d), dtype),
                            _OnCard((SLOTS, H, T, d), dtype),
                            _OnCard((SLOTS, H, T, d), dtype),
                            _OnCard((SLOTS,), torch.int32)) is None
