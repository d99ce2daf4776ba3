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

from bigdl_tpu.kernels.ragged_decode import \
    ragged_decode_attention as jax_ragged_decode
from bigdl_tpu_torch.kernels import decode_attention
from bigdl_tpu_torch.kernels.ragged_decode import (
    ragged_decode_attention, ragged_decode_attention_reference)

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
    q, k, v = (torch.from_numpy(a) for a in _inputs(seed=6))
    lengths = torch.ones(SLOTS, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention(q[:, :1], k, v, lengths)          # q/cache heads
    with pytest.raises(ValueError):
        decode_attention(q, k, v[:, :, :8], lengths)       # k/v shapes
    with pytest.raises(ValueError):
        decode_attention(q, k, v, lengths[:2])             # lengths
    with pytest.raises(TypeError):
        decode_attention(q.double(), k, v, lengths)        # mixed dtypes
    with pytest.raises(ValueError):                        # no such device
        ragged_decode_attention(q.to("meta"), k.to("meta"), v.to("meta"),
                                lengths.to("meta"))
