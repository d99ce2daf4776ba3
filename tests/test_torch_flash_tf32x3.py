"""The numerics of the flash kernels' tensor-core design, on the CPU.

K2's forward and the backward K1 and K2 share run their tile products
on the tensor cores in 3xTF32 (``csrc/flash_common.cuh``): each float32
operand is split into ``hi``, x rounded to TF32 to nearest with ties
away from zero (``cvt.rna.tf32.f32``'s rounding, which the kernels do
as an add and a mask on the bits), and ``lo = x - hi``, whose low 13
bits the MMA ignores; a product takes ``a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi`` with float32 sums. No card runs here, so this file emulates
that arithmetic with integer operations on the float32 bits and runs
attention's forward (O, lse) and the backward's five products (S, dP,
dV, dK, dQ) through it, against a float64 reference, on seeded
``[1, 2, S, 64]`` inputs at the main path's scale ``1/sqrt(64)``. It pins
three facts the kernels rely on:

* 3xTF32 keeps the float32 contract ``chip_smoke.py`` holds the kernels
  to: O and lse within ``FLASH_FWD_TOL`` (1e-5), the gradients within
  ``FLASH_BWD_TOL`` (2e-4), both absolute;
* plain TF32 (one product of the rounded operands) does not;
* the port's plain versions, which the kernels are compared with, are
  float32 (no TF32 in the reference): within a fifth of those limits,
  where TF32 misses them by about 100x.
"""
import math

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.kernels.flash_attention import (
    blockwise_flash_attention_backward_reference,
    blockwise_flash_attention_forward_reference,
    flash_attention_backward_reference, flash_attention_forward_reference)

#: chip_smoke.py's float32 limits for the kernels against their plain
#: versions (docs/kernels.md's float32 contract)
FLASH_FWD_TOL = 1e-5
FLASH_BWD_TOL = 2e-4
HEAD_DIM = 64
SCALE = 1.0 / math.sqrt(HEAD_DIM)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) as
    ``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero. On the
    bits: add half of the 13 dropped bits to the magnitude, then clear
    them (a carry into the exponent is the correct rounding up)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    sign = bits & np.uint32(0x80000000)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    return (sign | (mag & np.uint32(0xFFFFE000))).view(np.float32)


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """float32 ``x`` as the MMA reads a tf32 operand: its low 13 bits
    dropped."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def matmul(a: np.ndarray, b: np.ndarray, mode: str) -> np.ndarray:
    """``a @ b`` over float32 operands as the kernels' tensor cores do
    it (``"3xtf32"``) or as plain TF32 would (``"tf32"``). Products of
    tf32 values are exact in float32; the sums are float32."""
    a = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    b = torch.from_numpy(np.ascontiguousarray(b, np.float32))
    a_hi = torch.from_numpy(tf32_rna(a.numpy()))
    b_hi = torch.from_numpy(tf32_rna(b.numpy()))
    if mode == "tf32":
        return (a_hi @ b_hi).numpy()
    a_lo = torch.from_numpy(tf32_trunc((a - a_hi).numpy()))
    b_lo = torch.from_numpy(tf32_trunc((b - b_hi).numpy()))
    return (a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi).numpy()


def keep_mask(s: int, causal: bool, seg):
    """[B or 1, 1, S, S] keep-mask: causal and/or same segment."""
    keep = np.ones((1, 1, s, s), bool)
    if causal:
        keep &= np.tril(np.ones((s, s), bool))[None, None]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    return keep


def forward(q, k, v, keep, mm):
    """O and lse with the kernels' arithmetic (scores scaled after the
    q . k^T product) through the product ``mm``; float32 unless ``mm``
    is float64."""
    s = mm(q, np.swapaxes(k, -1, -2)) * SCALE
    s = np.where(keep, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    p = np.where(keep, np.exp(s - m), 0.0)
    l = p.sum(axis=-1, keepdims=True)
    o = mm(p, v) / l
    return o, (m + np.log(l))[..., 0]


def backward(q, k, v, o, do, lse, keep, mm):
    """dq, dk, dv from the saved O and lse, the five products of the
    kernels (dK/dV per key tile, dQ per query tile) through ``mm``."""
    s = mm(q, np.swapaxes(k, -1, -2)) * SCALE
    p = np.where(keep, np.exp(s - lse[..., None]), 0.0)
    dp = mm(do, np.swapaxes(v, -1, -2))
    delta = (do * o).sum(axis=-1, keepdims=True)
    ds = p * (dp - delta)
    dv = mm(np.swapaxes(p, -1, -2), do)
    dk = mm(np.swapaxes(ds, -1, -2), q) * SCALE
    dq = mm(ds * SCALE, k)
    return dq, dk, dv


def float64_mm(a, b):
    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)


def inputs(s: int, segmented: bool, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((1, 2, s, HEAD_DIM))
                   .astype(np.float32) for _ in range(4))
    seg = (np.sort(rng.integers(1, 4, (1, s)), axis=1).astype(np.int32)
           if segmented else None)
    return q, k, v, do, seg


def errors(q, k, v, do, seg, causal, mode):
    """Max absolute errors of O, lse, dq, dk, dv against float64, with
    the arithmetic of ``mode``: an emulated product (``"3xtf32"``,
    ``"tf32"``) or one of the port's plain versions (``"plain_k1"``,
    ``"plain_k2"``). The backward gets the float64 forward's O and lse
    rounded to float32, as the kernel gets its forward's."""
    keep = keep_mask(q.shape[2], causal, seg)
    o64, lse64 = forward(q, k, v, keep, float64_mm)
    g64 = backward(q, k, v, o64, do, lse64, keep, float64_mm)
    o32, lse32 = o64.astype(np.float32), lse64.astype(np.float32)
    if mode.startswith("plain"):
        fwd, bwd = {
            "plain_k1": (flash_attention_forward_reference,
                         flash_attention_backward_reference),
            "plain_k2": (blockwise_flash_attention_forward_reference,
                         blockwise_flash_attention_backward_reference),
        }[mode]
        t = [torch.from_numpy(x) for x in (q, k, v, do)]
        tseg = None if seg is None else torch.from_numpy(seg)
        o, lse = (x.numpy() for x in fwd(*t[:3], tseg, causal=causal,
                                          sm_scale=SCALE))
        grads = [g.numpy() for g in bwd(
            *t[:3], torch.from_numpy(o32), t[3], torch.from_numpy(lse32),
            tseg, causal=causal, sm_scale=SCALE)]
    else:
        def mm(a, b):
            return matmul(a, b, mode)

        o, lse = forward(q, k, v, keep, mm)
        grads = backward(q, k, v, o32, do, lse32, keep, mm)
    errs = {"o": np.abs(o - o64).max(), "lse": np.abs(lse - lse64).max()}
    for name, g, want in zip(("dq", "dk", "dv"), grads, g64):
        errs[name] = np.abs(g - want).max()
    return {name: float(e) for name, e in errs.items()}


@pytest.mark.parametrize("mode,s,causal,segmented", [
    ("3xtf32", 128, True, False),
    ("3xtf32", 512, True, True),
    ("3xtf32", 512, False, False),
    ("tf32", 128, True, False),
    ("tf32", 512, True, True),
    ("plain_k1", 512, True, True),
    ("plain_k2", 512, True, False),
    ("plain_k2", 256, False, True),
])
def test_flash_numerics(mode, s, causal, segmented):
    q, k, v, do, seg = inputs(s, segmented, seed=s + 7 * segmented)
    errs = errors(q, k, v, do, seg, causal, mode)
    limits = {"o": FLASH_FWD_TOL, "lse": FLASH_FWD_TOL,
              "dq": FLASH_BWD_TOL, "dk": FLASH_BWD_TOL, "dv": FLASH_BWD_TOL}
    if mode == "3xtf32":
        assert all(errs[n] <= limits[n] for n in limits), errs
    elif mode == "tf32":
        # one TF32 product is ~1e-3 relative: the forward misses its
        # limit by far, and so does at least one gradient
        assert errs["o"] > FLASH_FWD_TOL and errs["lse"] > FLASH_FWD_TOL, errs
        assert max(errs[n] / limits[n] for n in ("dq", "dk", "dv")) > 1, errs
    else:
        assert all(errs[n] <= limits[n] / 5 for n in limits), errs


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),       # below the tie: down
    (2.0 - 2.0 ** -23, 2.0),                    # carry into the exponent
    (2.0 ** -130 + 2.0 ** -140, 2.0 ** -130),   # subnormal: down
    (2.0 ** -130 + 2.0 ** -137, 2.0 ** -130 + 2.0 ** -136),  # its tie
])
def test_tf32_rna_rounds_ties_away_from_zero(x, want):
    assert tf32_rna(np.array([x], np.float32))[0] == np.float32(want)
