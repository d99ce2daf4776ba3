"""The port's fused dequant int8 GEMM (K5) against the JAX package's
Pallas kernel (run in interpret mode on the CPU) and its
``ops.quant.quantized_linear``, on the same seeded inputs.

Tolerance: none — bitwise (``docs/kernels.md`` "Equivalence contract":
the integer product is exact in any order and the epilogue multiplies
in one order in both packages); the bias is added outside the kernel in
both dispatch layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.kernels.int8_gemm import pallas_quantized_matmul
from bigdl_tpu.ops import quant as jax_quant
from bigdl_tpu_torch import kernels, telemetry
from bigdl_tpu_torch.kernels import dispatch
from bigdl_tpu_torch.kernels.int8_gemm import (cuda_unsupported, int8_gemm,
                                               int8_gemm_reference)
from bigdl_tpu_torch.ops import quant

SHAPES = [(1, 1, 1), (7, 3, 5), (17, 40, 24), (16, 8, 8), (33, 100, 10),
          (64, 2048, 40), (5, 4100, 9), (65, 64, 1)]


def _operands(seed, m, k, n):
    r = np.random.default_rng(seed)
    x = r.integers(-127, 128, (m, k), dtype=np.int8)
    w = r.integers(-127, 128, (n, k), dtype=np.int8)
    xs = (r.random(m) * 0.1 + 1e-3).astype(np.float32)
    ws = (r.random(n) * 0.1 + 1e-3).astype(np.float32)
    b = r.standard_normal(n).astype(np.float32)
    return x, w, xs, ws, b


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_version_bitwise_equals_pallas_interpret(m, k, n):
    x, w, xs, ws, _ = _operands(m * 31 + k + n, m, k, n)
    want = np.asarray(pallas_quantized_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ws),
        interpret=True))
    got = int8_gemm(*_t(x, w, xs, ws)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int8_gemm_reference(*_t(x, w, xs, ws)).dtype == torch.float32


@pytest.mark.parametrize("m,k,n", [(3, 20, 6), (24, 64, 16), (40, 4608, 8)])
def test_integer_product_is_exact_on_both_routes(m, k, n):
    """``torch._int_mm`` (24 and 40 rows) and the float64 product (3
    rows) both give numpy's int64 product."""
    x, w, *_ = _operands(m + k, m, k, n)
    want = x.astype(np.int64) @ w.astype(np.int64).T
    got = quant.int8_matmul(*_t(x, w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (9, 100, 30), (64, 256, 100)])
def test_dispatch_bitwise_equals_jax_quantized_linear(m, k, n, calibrated,
                                                      with_bias):
    """The port's dispatch (K5's plain version on the CPU) with the
    quantization ``QuantizedLinear`` feeds it, against JAX's
    ``quantized_linear`` on the same float input and weights; per-row
    (dynamic) and calibrated scalar activation scales."""
    r = np.random.default_rng(m * k + n)
    xf = r.standard_normal((m, k)).astype(np.float32)
    wf = (r.standard_normal((n, k)) * 0.1).astype(np.float32)
    b = r.standard_normal(n).astype(np.float32) if with_bias else None
    act = np.float32(0.021) if calibrated else None
    jw_q, jw_s = jax_quant.quantize_symmetric(jnp.asarray(wf), axis=0)
    want = np.asarray(jax_quant.quantized_linear(
        jnp.asarray(xf), jw_q, jw_s.reshape(-1),
        None if b is None else jnp.asarray(b), x_scale=act))

    w_q, w_s = quant.quantize_symmetric(torch.from_numpy(wf), axis=0)
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(jw_s))
    x = torch.from_numpy(xf)
    if act is None:
        x_q, x_s = quant.quantize_symmetric(x, axis=0)
        x_s = x_s.reshape(-1)
    else:
        x_s = torch.tensor(act).expand(m)
        x_q = quant.quantize_with_scale(x, x_s.reshape(-1, 1))
    bias = None if b is None else torch.from_numpy(b)
    with kernels.use(kernels.KernelConfig.ported()):
        got = kernels.int8_matmul(x_q, w_q, x_s, w_s.reshape(-1), bias)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = quant.quantized_linear(x, w_q, w_s.reshape(-1), bias,
                                   x_scale=act)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_dispatch_counts_and_the_live_int8_flag():
    x, w, xs, ws, _ = _operands(3, 4, 32, 8)
    x, w, xs, ws = _t(x, w, xs, ws)
    taken = telemetry.counter("kernels/dispatch/kernel")
    ref = telemetry.counter("kernels/dispatch/reference")
    t0 = taken.value(op="int8")
    c0 = ref.value(op="int8", reason="config")
    s0 = ref.value(op="int8", reason="shape")
    launches = int8_gemm.launches
    with kernels.use(kernels.KernelConfig.ported()):
        assert kernels.enabled("int8")
        assert kernels.int8_matmul(x, w, xs, ws) is not None
        assert kernels.int8_matmul(x, w[:, :16], xs, ws) is None
    with kernels.use(kernels.KernelConfig(int8_matmul=False)):
        assert not kernels.enabled("int8")
        assert kernels.int8_matmul(x, w, xs, ws) is None
    assert taken.value(op="int8") == t0 + 1
    assert ref.value(op="int8", reason="config") == c0 + 1
    assert ref.value(op="int8", reason="shape") == s0 + 1
    assert int8_gemm.launches == launches     # the CPU launches nothing


def test_scalar_scale_broadcasts_to_rows():
    x, w, xs, ws, _ = _operands(4, 6, 24, 5)
    x, w, ws = _t(x, w, ws)
    with kernels.use(kernels.KernelConfig.ported()):
        got = kernels.int8_matmul(x, w, torch.tensor(0.5), ws)
    want = int8_gemm_reference(x, w, torch.full((6,), 0.5), ws)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


class _OnCard:
    """Stands in for a CUDA tensor: routing reads only its shape, dtype,
    device and strides, so the CUDA branch is checked without a card."""

    def __init__(self, shape, dtype, contiguous=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.ndim, self.device = len(shape), torch.device("cuda")
        self._contiguous = contiguous

    def numel(self):
        return int(np.prod(self.shape))

    def is_contiguous(self):
        return self._contiguous

    def stride(self):
        return (1,) * self.ndim


@pytest.mark.parametrize("case,why", [
    ("float", "must be int8"), ("strided", "contiguous"),
    ("scale64", "float32"), ("ok", None)])
def test_cuda_operands_the_kernel_does_not_take(case, why):
    m, k, n = 8, 32, 16
    x = _OnCard((m, k), torch.float32 if case == "float" else torch.int8,
                contiguous=case != "strided")
    w = _OnCard((n, k), torch.int8)
    xs = _OnCard((m,), torch.float64 if case == "scale64" else torch.float32)
    ws = _OnCard((n,), torch.float32)
    got = cuda_unsupported(x, w, xs, ws)
    assert (got is None) if why is None else (why in got)


def test_cuda_shape_decline_raises_and_counts():
    ref = telemetry.counter("kernels/dispatch/reference")
    s0 = ref.value(op="int8", reason="shape")
    x = _OnCard((8, 32), torch.int8)
    w = _OnCard((16, 24), torch.int8)       # K differs
    with kernels.use(kernels.KernelConfig.ported()):
        with pytest.raises(ValueError, match="int8_matmul takes"):
            dispatch.int8_matmul(x, w, _OnCard((1,), torch.float32),
                                 _OnCard((16,), torch.float32))
    assert ref.value(op="int8", reason="shape") == s0 + 1


def test_wrapper_rejects_bad_shapes_and_devices():
    x, w, xs, ws, _ = _operands(5, 4, 16, 8)
    x, w, xs, ws = _t(x, w, xs, ws)
    with pytest.raises(ValueError):
        int8_gemm(x, w[:, :8], xs, ws)
    with pytest.raises(ValueError):
        int8_gemm(x, w, xs[:3], ws)
    with pytest.raises(ValueError):
        int8_gemm(x.to("meta"), w.to("meta"), xs.to("meta"), ws.to("meta"))


def test_jax_gate_would_decline_the_serving_shape():
    """The reason the port carries no alignment gate: ResNet-50's
    classifier shape fails the JAX package's TPU tile gate."""
    from bigdl_tpu.kernels.dispatch import _INT8_ALIGN
    m, n, k = 64, 1000, 2048
    assert not (m % _INT8_ALIGN[0] == 0 and n % _INT8_ALIGN[1] == 0
                and k % _INT8_ALIGN[2] == 0)
    assert jax.__version__
