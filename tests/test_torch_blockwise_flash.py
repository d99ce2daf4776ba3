"""The port's blockwise flash attention (K2), its dispatch route and the
attention layer's route for score matrices over 2 GiB (the K6 route),
against the JAX package's Pallas K2 run in interpret mode on the CPU,
on the same seeded inputs.

Tolerances: the forward (O and lse) at float32 atol 1e-5 and the
gradients at atol 2e-4 / rtol 1e-4 — the JAX kernel contract's rows
(docs/kernels.md, tests/test_kernels.py). The two packages take their
sums in other orders (torch einsum vs the Pallas interpreter's
dot_general); the tile walk and the online-softmax carry are the same.

A CUDA kernel cannot run here: the card's side of each route is checked
with stand-in CUDA operands (routing reads shape, dtype and device) and
a stubbed kernel library, and ``chip_smoke.py`` holds the kernel itself
against these plain versions on the card."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn.attention as jax_attention
from bigdl_tpu import kernels as jax_kernels
from bigdl_tpu.kernels import flash_attention as jax_fa
from bigdl_tpu_torch import kernels, telemetry
from bigdl_tpu_torch.kernels import dispatch
from bigdl_tpu_torch.kernels.flash_attention import (
    blockwise_flash_attention, blockwise_flash_attention_backward,
    blockwise_flash_attention_backward_reference,
    blockwise_flash_attention_forward,
    blockwise_flash_attention_forward_reference,
    flash_attention_backward_reference, flash_attention_forward_reference)
from bigdl_tpu_torch.nn import attention as port_attention
from bigdl_tpu_torch.nn import dot_product_attention

# the module, not the function the package exports under the same name
fa = importlib.import_module("bigdl_tpu_torch.kernels.flash_attention")

B, H, D, BLOCK_Q = 2, 2, 8, 16
FWD_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 1e-4


def _inputs(s, seed, segments, d=D):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, H, s, d)).astype(np.float32)
               for _ in range(3))
    seg = (np.sort(r.integers(1, 4, (B, s)), axis=1).astype(np.int32)
           if segments else None)
    return q, k, v, seg


def _t(a):
    return None if a is None else torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _jax_fn(causal, segmented, block_k):
    def fwd(q, k, v, seg):
        return jax_fa.blockwise_flash_attention(
            q, k, v, seg if segmented else None, causal=causal,
            block_q=BLOCK_Q, block_k=block_k, interpret=True)

    def loss(q, k, v, seg):
        return (fwd(q, k, v, seg) ** 2).sum()

    return jax.jit(fwd), jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def _jax_seg(seg, s):
    return seg if seg is not None else np.zeros((B, s), np.int32)


# ------------------------------------------------------ K2 vs JAX's K2

@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_k", [8, 16, 48])
def test_forward_matches_jax_k2(block_k, causal, segmented):
    q, k, v, seg = _inputs(48, seed=block_k, segments=segmented)
    fwd, _ = _jax_fn(causal, segmented, block_k)
    want = np.asarray(fwd(q, k, v, _jax_seg(seg, 48)))
    got = blockwise_flash_attention(_t(q), _t(k), _t(v), _t(seg),
                                    causal=causal, block_q=BLOCK_Q,
                                    block_k=block_k)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax_k2_where_key_tiles_are_masked_whole(causal):
    """Segments laid out so that, at block_k 8, whole key tiles are
    masked for the rows of a later segment: their carry stays at
    (-inf, 0, 0) until the first tile of their own segment, in both
    packages."""
    q, k, v, _ = _inputs(48, seed=31, segments=False)
    seg = np.array([[1] * 20 + [2] * 28, [1] * 40 + [2] * 3 + [3] * 5],
                   np.int32)
    fwd, _ = _jax_fn(causal, True, 8)
    want = np.asarray(fwd(q, k, v, seg))
    got, lse = blockwise_flash_attention_forward(
        _t(q), _t(k), _t(v), _t(seg), causal=causal, block_q=BLOCK_Q,
        block_k=8)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_k2(causal, segmented):
    """The gradients of ``(out**2).sum()``: the port's plain backward
    through its autograd Function against ``jax.grad`` of the
    interpret-mode K2 (whose backward is ``_bw_dq_kernel`` and
    ``_bw_dkv_kernel``), at s=32, block_q 16, block_k 8."""
    q, k, v, seg = _inputs(32, seed=200 + causal, segments=segmented)
    _, grad = _jax_fn(causal, segmented, 8)
    want = grad(q, k, v, _jax_seg(seg, 32))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = blockwise_flash_attention(tq, tk, tv, _t(seg), causal=causal,
                                    block_q=BLOCK_Q, block_k=8)
    (out ** 2).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"d{name}")


def test_lse_is_the_masked_log_sum_exp():
    q, k, v, seg = (_t(a) for a in _inputs(24, seed=7, segments=True))
    _, lse = blockwise_flash_attention_forward(q, k, v, seg, causal=True,
                                               block_q=8, block_k=8)
    scores = torch.einsum("bhqd,bhkd->bhqk", q / np.sqrt(D), k)
    keep = torch.ones((24, 24), dtype=torch.bool).tril()[None, None] \
        & (seg[:, None, :, None] == seg[:, None, None, :])
    want = scores.masked_fill(~keep, float("-inf")).logsumexp(-1)
    torch.testing.assert_close(lse, want, atol=FWD_ATOL, rtol=0)


def test_fully_masked_tile_keeps_the_carry_and_a_dead_row_gives_zero():
    """A key tile masked whole leaves an empty carry at exactly
    (-inf, 0, 0), with no NaN; a row whose every tile was masked
    finishes at O = 0 and lse = -inf."""
    m = torch.full((1, 1, 4, 1), float("-inf"))
    l, acc = torch.zeros((1, 1, 4, 1)), torch.zeros((1, 1, 4, D))
    scores = torch.randn((1, 1, 4, 8))
    vt = torch.randn((1, 1, 8, D))
    keep = torch.zeros((1, 1, 4, 8), dtype=torch.bool)
    keep[..., 1:, :3] = True                    # row 0 stays masked
    m, l, acc = fa._online_update(m, l, acc, scores, keep, vt)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    assert m[..., 0, 0] == float("-inf") and l[..., 0, 0] == 0
    out, lse = fa._finish(m, l, acc)
    assert torch.equal(out[..., 0, :], torch.zeros((1, 1, D)))
    assert lse[..., 0] == float("-inf")
    assert torch.isfinite(out).all() and torch.isfinite(lse[..., 1:]).all()


def test_dead_row_gives_finite_zero_gradients():
    """The backward recomputes p from lse: a row with lse = -inf (a
    fully masked row) has p = 0, so its dq is exactly zero and it adds
    nothing to dk or dv; every gradient stays finite."""
    q, k, v, _ = (_t(a) for a in _inputs(16, seed=5, segments=False))
    o, lse = blockwise_flash_attention_forward_reference(
        q, k, v, causal=True, block_q=8, block_k=8)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    dead_lse = lse.clone()
    dead_lse[:, :, 5] = float("-inf")
    dq, dk, dv = blockwise_flash_attention_backward_reference(
        q, k, v, o, do, dead_lse, causal=True, block_q=8, block_k=8)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert torch.equal(dq[:, :, 5], torch.zeros_like(dq[:, :, 5]))
    # dv without row 5 is the full dv minus row 5's p^T . dO
    _, _, dv_live = blockwise_flash_attention_backward_reference(
        q, k, v, o, do, lse, causal=True, block_q=8, block_k=8)
    p5 = torch.exp(torch.einsum("bhd,bhkd->bhk", q[:, :, 5] / np.sqrt(D),
                                k) - lse[:, :, 5, None])
    p5[..., 6:] = 0
    want = dv_live - torch.einsum("bhk,bhd->bhkd", p5, do[:, :, 5])
    torch.testing.assert_close(dv, want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_k", [8, 16, 48])
def test_k2_plain_equals_k1_plain(block_k, causal):
    """One function, two tilings: K2's online-softmax plain version
    equals K1's full-row one (forward and backward) within the forward
    tolerance, at every key tile width — the routing switch between
    them is invisible to callers."""
    q, k, v, seg = (_t(a) for a in _inputs(48, seed=60 + block_k,
                                           segments=True))
    o1, l1 = flash_attention_forward_reference(q, k, v, seg, causal=causal,
                                               block_q=BLOCK_Q)
    o2, l2 = blockwise_flash_attention_forward_reference(
        q, k, v, seg, causal=causal, block_q=BLOCK_Q, block_k=block_k)
    torch.testing.assert_close(o2, o1, atol=FWD_ATOL, rtol=0)
    torch.testing.assert_close(l2, l1, atol=FWD_ATOL, rtol=0)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    g1 = flash_attention_backward_reference(q, k, v, o1, do, l1, seg,
                                            causal=causal, block_q=BLOCK_Q)
    g2 = blockwise_flash_attention_backward_reference(
        q, k, v, o1, do, l1, seg, causal=causal, block_q=BLOCK_Q,
        block_k=block_k)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, atol=FWD_ATOL, rtol=0)


def test_plain_version_is_tile_independent():
    q, k, v, seg = (_t(a) for a in _inputs(48, seed=11, segments=True))
    ref, ref_lse = blockwise_flash_attention_forward_reference(
        q, k, v, seg, causal=True, block_q=48, block_k=48)
    for bq, bk in ((16, 8), (8, 16), (24, 12), (48, 1)):
        o, lse = blockwise_flash_attention_forward_reference(
            q, k, v, seg, causal=True, block_q=bq, block_k=bk)
        torch.testing.assert_close(o, ref, atol=1e-6, rtol=0)
        torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=0)


def test_cpu_call_counts_no_launch():
    q, k, v, seg = _inputs(32, seed=9, segments=True)
    f0 = blockwise_flash_attention_forward.launches
    b0 = blockwise_flash_attention_backward.launches
    tq = _t(q).requires_grad_()
    blockwise_flash_attention(tq, _t(k), _t(v), _t(seg), causal=True,
                              block_k=8).sum().backward()
    assert tq.grad is not None
    assert blockwise_flash_attention_forward.launches == f0
    assert blockwise_flash_attention_backward.launches == b0


# ------------------------------------------------------------ dispatch

def _seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_budget_routes_k2_in_both_packages_with_equal_results(causal,
                                                              monkeypatch):
    """At [1, 1, 512, 16] the working-set estimate is 1.28 MB, past a
    1 MiB budget: both dispatches take K2 with 128-row tiles, the port
    through K2's plain version (spied), counted as op=flash, and the
    two results agree at the forward tolerance."""
    shape = (1, 1, 512, 16)
    q, k, v = (_seeded(shape, 70 + i) for i in range(3))
    jcfg = jax_kernels.KernelConfig.all_on(interpret=True, vmem_budget_mb=1,
                                           block_q=128, block_k=128)
    pcfg = kernels.KernelConfig.ported(vmem_budget_mb=1, block_q=128,
                                       block_k=128)
    with jax_kernels.use(jcfg):
        want = np.asarray(jax_kernels.attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = _t(q), _t(k), _t(v)
    assert dispatch.flash_route(tq, tk, tv, pcfg) == "K2"
    tiles = []
    real = fa.blockwise_flash_attention_forward_reference

    def spy(*a, **kw):
        tiles.append((kw["block_q"], kw["block_k"]))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "blockwise_flash_attention_forward_reference",
                        spy)
    taken = telemetry.counter("kernels/dispatch/kernel")
    t0 = taken.value(op="flash")
    with kernels.use(pcfg):
        got = kernels.attention(tq, tk, tv, causal=causal)
    assert tiles == [(128, 128)]
    assert taken.value(op="flash") == t0 + 1
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


class _OnCard:
    """Stands in for a contiguous CUDA tensor: routing and the launch
    helpers read its shape, dtype, device, strides and pointer, so the
    card's branch runs here up to the (stubbed) kernel call."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda", 0)

    def stride(self, dim=None):
        st = torch.empty(self.shape, device="meta").stride()
        return st if dim is None else st[dim]

    def numel(self):
        return self.shape.numel()

    def data_ptr(self):
        return 0

    def contiguous(self):
        return self


class _StubLibrary:
    """Records which entry point a launch calls; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append(name) or 0


@pytest.fixture
def on_card(monkeypatch):
    """Stand-in CUDA allocation and stream, and a stub kernel library."""
    lib = _StubLibrary()
    monkeypatch.setattr(fa, "_library", lambda source, prefix: lib)
    real_empty = torch.empty

    def empty(*args, **kw):
        device = kw.get("device")
        if device is not None and torch.device(device).type == "cuda":
            return _OnCard(args[0], kw["dtype"])
        return real_empty(*args, **kw)

    monkeypatch.setattr(fa.torch, "empty", empty)
    monkeypatch.setattr(fa.torch, "empty_like",
                        lambda x: _OnCard(x.shape, x.dtype))
    monkeypatch.setattr(fa.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    return lib


def test_k2_route_on_the_card_reaches_the_kernel_launch(on_card,
                                                        monkeypatch):
    """Past the budget a CUDA tensor goes to K2's kernel: the dispatch
    calls K2 (whose autograd Function, which saves real tensors, is
    stood in for by its forward wrapper here) and the forward and
    backward wrappers reach their entry points — no NotImplementedError,
    no plain version — counting one launch each."""
    shape = (1, 8, 8192, 64)
    q = _OnCard(shape, torch.float32)
    monkeypatch.setattr(
        dispatch, "blockwise_flash_attention",
        lambda q, k, v, seg, **kw: blockwise_flash_attention_forward(
            q, k, v, seg, **kw)[0])
    f0 = blockwise_flash_attention_forward.launches
    b0 = blockwise_flash_attention_backward.launches
    with kernels.use(kernels.KernelConfig.ported()):
        assert dispatch.flash_route(q, q, q) == "K2"
        out = kernels.attention(q, q, q, causal=True)
        _, lse = blockwise_flash_attention_forward(q, q, q, causal=True)
        blockwise_flash_attention_backward(q, q, q, out, q, lse,
                                           causal=True)
    assert isinstance(out, _OnCard) and out.shape == shape
    assert on_card.calls == ["bigdl_blockwise_fwd_f32"] * 2 + [
        "bigdl_blockwise_bwd_f32"]
    assert blockwise_flash_attention_forward.launches == f0 + 2
    assert blockwise_flash_attention_backward.launches == b0 + 1


@pytest.mark.parametrize("reader,entry,n", [
    ("flash_attention_forward_tile_pairs", "bigdl_flash_tile_pairs", 1),
    ("flash_attention_backward_tile_pairs", "bigdl_flash_bwd_tile_pairs", 2),
    ("blockwise_flash_attention_forward_tile_pairs",
     "bigdl_blockwise_tile_pairs", 1),
    ("blockwise_flash_attention_backward_tile_pairs",
     "bigdl_blockwise_bwd_tile_pairs", 2)])
def test_tile_pair_readers_reach_their_library_entry(reader, entry, n,
                                                     on_card):
    """The tile-pair readers of K1 and K2 (the record that the 16-bit
    kernels skipped the unshared tile pairs) call their own library's
    entry point once, for the card named, and return its counts: one
    for a forward, (dK/dV, dQ) for a backward."""
    got = getattr(fa, reader)(device="cuda:0")
    assert on_card.calls == [entry]
    assert got == (0 if n == 1 else (0, 0))


@pytest.mark.parametrize("d,dtype", [(129, torch.float32),
                                     (256, torch.bfloat16),
                                     (64, torch.float64)])
def test_k2_route_cuda_operands_the_kernel_does_not_take_raise(d, dtype,
                                                               on_card):
    """Past the budget too, operands the CUDA kernels do not take are a
    reason=shape decline that raises on the card, never a kernel call."""
    q = _OnCard((1, 8, 8192, d), dtype)
    ref = telemetry.counter("kernels/dispatch/reference")
    s0 = ref.value(op="flash", reason="shape")
    with kernels.use(kernels.KernelConfig.ported()):
        assert dispatch.flash_route(q, q, q) == "shape"
        assert dispatch.flash_route(
            *[torch.empty((1, 1, 8192, d), dtype=dtype, device="meta")] * 3
        ) == "K2"
        with pytest.raises(ValueError, match="flash_attention kernel takes"):
            kernels.attention(q, q, q, causal=True)
    assert ref.value(op="flash", reason="shape") == s0 + 1
    assert on_card.calls == []


# ------------------------------------------------------------ K6 route

_ELIGIBLE = [(b, h, s, d, dt, mask, dropout, training)
             for b, h, s, d in ((1, 8, 16384, 128), (1, 8, 8192, 128),
                                (2, 8, 16384, 64), (1, 16, 16384, 256),
                                (1, 8, 16400, 128), (4, 8, 8192, 128))
             for dt in ("float32", "bfloat16")
             for mask, dropout, training in ((False, 0.0, False),
                                             (True, 0.0, False),
                                             (False, 0.1, True))]


@pytest.mark.parametrize("b,h,s,d,dt,mask,dropout,training", _ELIGIBLE)
def test_flash_eligible_equals_jax(b, h, s, d, dt, mask, dropout,
                                   training):
    jq = jax.ShapeDtypeStruct((b, h, s, d), getattr(jnp, dt))
    tq = torch.empty((b, h, s, d), dtype=getattr(torch, dt), device="meta")
    want = jax_attention._flash_eligible(jq, object() if mask else None,
                                         dropout, training)
    got = port_attention._flash_eligible(tq, object() if mask else None,
                                         dropout, training)
    assert got == want
    assert port_attention._FLASH_SCORE_BYTES == \
        jax_attention._FLASH_SCORE_BYTES


def test_k6_route_is_never_taken_on_the_cpu(monkeypatch):
    """On the CPU the einsum path runs even where the rule holds, as the
    JAX package takes the route on a TPU only."""
    monkeypatch.setattr(port_attention, "_flash_eligible",
                        lambda *a: True)
    monkeypatch.setattr(kernels, "blockwise_flash_attention",
                        lambda *a, **kw: pytest.fail("K6 route taken"))
    q, k, v, _ = (_t(a) for a in _inputs(32, seed=17, segments=False))
    with kernels.use(kernels.KernelConfig.off()):
        got = dot_product_attention(q, k, v, causal=True)
        want = dot_product_attention(q, k, v, causal=True, use_flash=False)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cfg,use_flash,masked,calls", [
    (kernels.KernelConfig(flash_attention=False, decode_attention=True),
     True, False, 1),
    (kernels.KernelConfig.ported(long_context=False), True, False, 1),
    (kernels.KernelConfig.off(), False, False, 0),
    (kernels.KernelConfig.off(), True, True, 0)])
def test_k6_route_on_the_card_goes_to_k2(cfg, use_flash, masked, calls,
                                         monkeypatch):
    """A CUDA q whose scores exceed 2 GiB ([1, 8, 16384, 128] float32:
    8.6 GB), flash switched off or declined as reason=vmem: the attention
    layer calls K2 (spied) causal with 1/sqrt(D); not with use_flash
    off or a mask."""
    seen = []
    monkeypatch.setattr(
        kernels, "blockwise_flash_attention",
        lambda q, k, v, **kw: seen.append(kw) or "K2 result")
    q = _OnCard((1, 8, 16384, 128), torch.float32)
    mask = torch.ones((1, 1, 4, 4), dtype=torch.bool) if masked else None
    with kernels.use(cfg):
        try:
            out = dot_product_attention(q, q, q, causal=True, mask=mask,
                                        use_flash=use_flash)
        except (AttributeError, TypeError):
            out = "einsum path"      # a stand-in has no data to multiply
    assert len(seen) == calls
    if calls:
        assert out == "K2 result"
        assert seen == [{"causal": True, "sm_scale": 1.0 / np.sqrt(128)}]
    else:
        assert out == "einsum path"
