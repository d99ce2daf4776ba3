"""The port's flash attention (K1) against the JAX package's Pallas
kernel run in interpret mode on the CPU, on the same seeded inputs; the
port's kernel config and routing against the JAX package's.

Tolerances: the forward at float32 atol 1e-5 and the gradients at atol
2e-4 — the JAX kernel contract's rows (docs/kernels.md); the two
packages take their sums in other orders (torch einsum vs the Pallas
interpreter's dot_general), nothing else differs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.telemetry as jax_telemetry
from bigdl_tpu import kernels as jax_kernels
from bigdl_tpu.kernels import flash_attention as jax_fa
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.kernels import dispatch
from bigdl_tpu_torch.kernels.flash_attention import (
    cuda_unsupported, flash_attention, flash_attention_backward,
    flash_attention_forward, flash_attention_forward_reference)
from bigdl_tpu_torch.nn import dot_product_attention

B, H, D, BLOCK_Q = 2, 2, 8, 16
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-4


def _inputs(s, seed, segments):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((B, H, s, D)).astype(np.float32)
               for _ in range(3))
    seg = (np.sort(r.integers(1, 4, (B, s)), axis=1).astype(np.int32)
           if segments else None)
    return q, k, v, seg


@functools.lru_cache(maxsize=None)
def _jax_fn(causal, segmented):
    def fwd(q, k, v, seg):
        return jax_fa.flash_attention(q, k, v, seg if segmented else None,
                                      causal=causal, block_q=BLOCK_Q,
                                      interpret=True)

    def loss(q, k, v, seg):
        return (fwd(q, k, v, seg) ** 2).sum()

    return jax.jit(fwd), jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [19, 32, 48])
def test_forward_matches_jax_kernel(s, causal, segmented):
    q, k, v, seg = _inputs(s, seed=s, segments=segmented)
    fwd, _ = _jax_fn(causal, segmented)
    want = np.asarray(fwd(q, k, v, seg if segmented else
                          np.zeros((B, s), np.int32)))
    got = flash_attention(_t(q), _t(k), _t(v), _t(seg), causal=causal,
                          block_q=BLOCK_Q)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [19, 32, 48])
def test_gradients_match_jax_kernel(s, causal, segmented):
    """The gradients of ``(out**2).sum()``: the port's plain backward
    through its autograd Function against ``jax.grad`` of the
    interpret-mode kernel (whose backward is the Pallas ``_bwd_kernel``)."""
    q, k, v, seg = _inputs(s, seed=100 + s, segments=segmented)
    _, grad = _jax_fn(causal, segmented)
    want = grad(q, k, v, seg if segmented else np.zeros((B, s), np.int32))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, _t(seg), causal=causal,
                          block_q=BLOCK_Q)
    (out ** 2).sum().backward()
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_lse_is_the_masked_log_sum_exp():
    """lse is logsumexp over each row's kept scores (q scaled first),
    which the backward reads to recompute p."""
    q, k, v, seg = (_t(a) for a in _inputs(24, seed=7, segments=True))
    _, lse = flash_attention_forward(q, k, v, seg, causal=True, block_q=8)
    scores = torch.einsum("bhqd,bhkd->bhqk", q / np.sqrt(D), k)
    keep = torch.ones((24, 24), dtype=torch.bool).tril()[None, None] \
        & (seg[:, None, :, None] == seg[:, None, None, :])
    want = scores.masked_fill(~keep, float("-inf")).logsumexp(-1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=0)


def test_cpu_call_counts_no_launch():
    q, k, v, seg = _inputs(32, seed=9, segments=True)
    f0 = flash_attention_forward.launches
    b0 = flash_attention_backward.launches
    tq = _t(q).requires_grad_()
    flash_attention(tq, _t(k), _t(v), _t(seg), causal=True).sum().backward()
    assert flash_attention_forward.launches == f0
    assert flash_attention_backward.launches == b0


def test_reference_is_tile_independent():
    """The plain forward gives the same answer for every query tiling
    (rows are independent; each reduces its full key row)."""
    q, k, v, seg = (_t(a) for a in _inputs(48, seed=11, segments=True))
    a, la = flash_attention_forward_reference(q, k, v, seg, causal=True,
                                              block_q=48)
    b, lb = flash_attention_forward_reference(q, k, v, seg, causal=True,
                                              block_q=16)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(la, lb, rtol=0, atol=1e-6)


# ------------------------------------------------------------ config

@pytest.mark.parametrize("value", [
    "1", "on", "all", "true", "0", "off", "false", "none", "",
    "flash", "decode", "int8", "flash,decode", " Flash , int8 ",
    "decode,int8,flash"])
def test_kernels_env_grammar_matches_jax(value):
    want = jax_kernels.KernelConfig.from_env(value)
    got = kernels.KernelConfig.from_env(value)
    assert (got.flash_attention, got.decode_attention, got.int8_matmul) \
        == (want.flash_attention, want.decode_attention, want.int8_matmul)


@pytest.mark.parametrize("value", ["flsh", "flash,paged", "gemm"])
def test_unknown_kernel_names_raise_in_both(value):
    with pytest.raises(ValueError):
        jax_kernels.KernelConfig.from_env(value)
    with pytest.raises(ValueError):
        kernels.KernelConfig.from_env(value)


def test_default_is_flash_and_decode(monkeypatch):
    """The default is every kernel the port has: flash and decode, and
    since K5 was ported, int8."""
    monkeypatch.delenv("BIGDL_KERNELS", raising=False)
    monkeypatch.setattr(kernels.config, "_CONFIG", None)
    cfg = kernels.get_config()
    assert (cfg.flash_attention, cfg.decode_attention, cfg.int8_matmul) \
        == (True, True, True)
    monkeypatch.setenv("BIGDL_KERNELS", "decode")
    monkeypatch.setattr(kernels.config, "_CONFIG", None)
    assert not kernels.get_config().flash_attention


def test_vmem_budget_env_and_bounds(monkeypatch):
    cfg = kernels.KernelConfig.all_on()
    monkeypatch.delenv("BIGDL_VMEM_BUDGET_MB", raising=False)
    assert cfg.resolve_vmem_budget() == 12 << 20
    monkeypatch.setenv("BIGDL_VMEM_BUDGET_MB", "3")
    assert cfg.resolve_vmem_budget() == 3 << 20
    assert kernels.KernelConfig.all_on(
        vmem_budget_mb=5).resolve_vmem_budget() == 5 << 20
    monkeypatch.setenv("BIGDL_VMEM_BUDGET_MB", "lots")
    with pytest.raises(ValueError):
        cfg.resolve_vmem_budget()
    with pytest.raises(ValueError):
        kernels.KernelConfig.all_on(vmem_budget_mb=0).resolve_vmem_budget()


# ------------------------------------------------------------ routing

def _jax_route(q, cfg):
    """The route the JAX dispatch takes: which kernel function it calls
    (spied), or the reason= label of the decline it counts."""
    taken = []
    real = (jax_fa.flash_attention, jax_fa.blockwise_flash_attention)
    jax_fa.flash_attention = lambda *a, **kw: taken.append("K1") or q
    jax_fa.blockwise_flash_attention = \
        lambda *a, **kw: taken.append("K2") or q
    ref = jax_telemetry.counter("kernels/dispatch/reference")
    before = {r: ref.value(op="flash", reason=r)
              for r in ("config", "shape", "vmem")}
    try:
        with jax_kernels.use(cfg):
            out = jax_kernels.attention(q, q, q, causal=True)
    finally:
        jax_fa.flash_attention, jax_fa.blockwise_flash_attention = real
    if out is not None:
        return taken[0]
    return next(r for r in before
                if ref.value(op="flash", reason=r) > before[r])


_ROUTING = [(flash, budget, long_ctx, s, d, dt)
            for flash in (True, False)
            for budget in (1, 12)
            for long_ctx in (True, False)
            for s, d in ((64, 16), (512, 64), (1024, 64), (2048, 128))
            for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("flash,budget,long_ctx,s,d,dt", _ROUTING)
def test_routing_matches_jax_dispatch(flash, budget, long_ctx, s, d, dt):
    shape = (1, 1, s, d)
    jq = jnp.zeros(shape, getattr(jnp, dt))
    tq = torch.zeros(shape, dtype=getattr(torch, dt))
    want = _jax_route(jq, jax_kernels.KernelConfig(
        flash_attention=flash, vmem_budget_mb=budget,
        long_context=long_ctx))
    got = dispatch.flash_route(tq, tq, tq, kernels.KernelConfig(
        flash_attention=flash, vmem_budget_mb=budget,
        long_context=long_ctx))
    assert got == want


def test_shape_decline_matches_jax_and_runs_einsum_on_cpu():
    q = torch.zeros((2, 3, 4))                        # not [B, H, S, D]
    jq = jnp.zeros((2, 3, 4))
    assert _jax_route(jq, jax_kernels.KernelConfig.all_on()) == "shape"
    with kernels.use(kernels.KernelConfig.ported()):
        assert dispatch.flash_route(q, q, q) == "shape"
        assert kernels.attention(q, q, q) is None


def test_declines_are_counted_with_reasons():
    from bigdl_tpu_torch import telemetry
    ref = telemetry.counter("kernels/dispatch/reference")
    taken = telemetry.counter("kernels/dispatch/kernel")
    q = torch.zeros((1, 1, 16, 8))
    c0 = ref.value(op="flash", reason="config")
    v0 = ref.value(op="flash", reason="vmem")
    t0 = taken.value(op="flash")
    with kernels.use(kernels.KernelConfig.off()):
        assert kernels.attention(q, q, q) is None
    big = torch.zeros((1, 1, 1024, 16))
    with kernels.use(kernels.KernelConfig.ported(vmem_budget_mb=1,
                                                 long_context=False)):
        assert kernels.attention(big, big, big) is None
    with kernels.use(kernels.KernelConfig.ported()):
        assert kernels.attention(q, q, q) is not None
    assert ref.value(op="flash", reason="config") == c0 + 1
    assert ref.value(op="flash", reason="vmem") == v0 + 1
    assert taken.value(op="flash") == t0 + 1


class _OnCard:
    """Stands in for a CUDA tensor: routing reads only its shape, dtype
    and device, so the CUDA branch is checked without a card."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda")


@pytest.mark.parametrize("d,dtype,takes", [
    (64, torch.float32, True), (96, torch.bfloat16, True),
    (80, torch.float16, True), (1, torch.float32, True),
    (128, torch.float16, True), (129, torch.float32, False),
    (256, torch.bfloat16, False), (64, torch.float64, False)])
def test_cuda_operands_the_kernel_does_not_take_raise_as_shape(d, dtype,
                                                                takes):
    """Head dims up to 128 in float32/bfloat16/float16 route to K1 on the
    card; past that the CUDA route is a reason=shape decline, which
    raises there and is never counted as a kernel call. On the CPU the
    same shapes route as the JAX package routes them."""
    from bigdl_tpu_torch import telemetry
    q = _OnCard((2, 8, 64, d), dtype)
    assert (cuda_unsupported(q.shape, dtype) is None) == takes
    with kernels.use(kernels.KernelConfig.ported()):
        assert dispatch.flash_route(q, q, q) == ("K1" if takes else "shape")
        assert dispatch.flash_route(torch.zeros(q.shape, dtype=dtype),
                                    *[torch.zeros(q.shape, dtype=dtype)] * 2
                                    ) == "K1"
        if takes:
            return
        ref = telemetry.counter("kernels/dispatch/reference")
        taken = telemetry.counter("kernels/dispatch/kernel")
        s0, t0 = ref.value(op="flash", reason="shape"), taken.value(op="flash")
        with pytest.raises(ValueError, match="flash_attention kernel takes"):
            kernels.attention(q, q, q, causal=True)
        assert ref.value(op="flash", reason="shape") == s0 + 1
        assert taken.value(op="flash") == t0


@pytest.mark.parametrize("shape,k_dtype", [
    ((1, 2, 32, 64), torch.bfloat16),         # q float32, k bfloat16
    ((65536, 1, 16, 64), torch.float32)])     # past the grid's 65535
def test_other_cuda_operands_route_as_shape(shape, k_dtype):
    q = _OnCard(shape, torch.float32)
    k = _OnCard(shape, k_dtype)
    assert dispatch.flash_route(q, k, q, kernels.KernelConfig.ported()) \
        == "shape"


def test_k2_route_runs_plain_attention_on_cpu():
    """Past the budget a CPU tensor runs K2's plain version, with the
    config's block_q / block_k tiles (as the JAX dispatch passes them);
    inside it, K1's."""
    from bigdl_tpu_torch.kernels.flash_attention import (
        blockwise_flash_attention_forward_reference)
    big = tuple(_t(a[:1, :1]) for a in _inputs(1024, seed=12,
                                               segments=False)[:3])
    cfg = kernels.KernelConfig.ported(vmem_budget_mb=1, block_q=64,
                                      block_k=32)
    with kernels.use(cfg):
        assert dispatch.flash_route(*big) == "K2"
        out = kernels.attention(*big, causal=True)
    want, _ = blockwise_flash_attention_forward_reference(
        *big, causal=True, block_q=64, block_k=32)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    q, k, v, seg = (_t(a) for a in _inputs(32, seed=12, segments=True))
    with kernels.use(kernels.KernelConfig.ported()):
        assert dispatch.flash_route(q, k, v) == "K1"
        got = kernels.attention(q, k, v, causal=True, segment_ids=seg)
    torch.testing.assert_close(
        got, flash_attention(q, k, v, seg, causal=True), rtol=0, atol=0)


# ------------------------------------------------------ nn.attention

def test_mask_and_segments_together_raise():
    q = torch.zeros((1, 1, 8, 4))
    seg = torch.ones((1, 8), dtype=torch.int32)
    mask = torch.ones((1, 1, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="not both"):
        dot_product_attention(q, q, q, mask=mask, segments=seg)


def test_einsum_segments_equal_explicit_mask_and_kernel_route():
    """With flash off, ``segments`` derives the same-segment mask: the
    einsum output equals the explicit-mask output bitwise; with flash on
    the kernel's plain version agrees at the forward tolerance."""
    q, k, v, seg = (_t(a) for a in _inputs(32, seed=13, segments=True))
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    with kernels.use(kernels.KernelConfig.off()):
        a = dot_product_attention(q, k, v, causal=True, segments=seg)
        b = dot_product_attention(q, k, v, causal=True, mask=mask)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with kernels.use(kernels.KernelConfig.ported()):
        c = dot_product_attention(q, k, v, causal=True, segments=seg)
    torch.testing.assert_close(c, a, rtol=0, atol=FWD_ATOL)


def test_training_dropout_is_not_ported():
    """Training dropout raised here until it was ported (the test keeps
    its name): in training at a rate above 0 the kernels are bypassed;
    without a generator nothing is drawn (the einsum path's output,
    bitwise), with one the weights are dropped."""
    q = torch.randn((1, 1, 8, 4), generator=torch.Generator().manual_seed(0))
    with kernels.use(kernels.KernelConfig.off()):
        plain = dot_product_attention(q, q, q)
    got = dot_product_attention(q, q, q, dropout_rate=0.1, training=True)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    dropped = dot_product_attention(
        q, q, q, dropout_rate=0.5, training=True,
        generator=torch.Generator().manual_seed(1))
    assert not torch.equal(dropped, plain)
