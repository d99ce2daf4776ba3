"""The convolutions, normalizations and pools of the port's last slice of
``nn`` (``bigdl_tpu_torch/nn/conv.py``: ``SpatialShareConvolution``,
``SpatialDilatedConvolution``, ``SpatialFullConvolution``,
``VolumetricConvolution``, ``VolumetricFullConvolution``,
``SpatialConvolutionMap``; ``nn/norm.py``: ``Normalize`` and the
subtractive, divisive and contrastive normalizations; ``nn/pool.py``:
``TemporalMaxPooling``, ``VolumetricMaxPooling``, ``RoiPooling``) against
the JAX package's on the same seeded inputs: the outputs and the
gradients of a seeded scalar loss with respect to the floating inputs
and every parameter (the port's parameters carried into the JAX
module).

The cases include what PyTorch's ops do not take as the JAX package
does: grouped and ``adj >= stride`` transposed convolutions, an even
normalization kernel (padded unevenly), a max-pool pad beyond half the
kernel, and RoiPooling with a roi across the border, one off the map
(its bins empty: 0) and tied maxima (the gradient spread evenly, as
``jnp.max`` spreads it). The other max pools' inputs have no ties: a
pool's gradient goes to one of its tied inputs, and which one is the
op's choice. RoiPooling's JAX side runs eagerly: jitted, XLA's CPU
backend computes a bin edge such as ``ceil(3 * (7 / 3))`` through the
reciprocal of 3 and takes one column more than the formula (and the
eager JAX package, and the port) does.

Tolerance (float32): 1e-5 absolute and relative, 2e-5 for the 3-D
convolutions, whose gradients sum a few thousand products."""
import json

import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.optim.regularizer import L2Regularizer as JL2
from bigdl_tpu.utils import module_serializer as jms
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.norm import _gaussian_kernel_2d
from bigdl_tpu_torch.optim.regularizer import L2Regularizer
from bigdl_tpu_torch.utils import module_serializer as ms
from bigdl_tpu_torch.utils.table import T

from _torch_parity import assert_table_parity

TOL = 1e-5
TOL_3D = 2e-5

torch.set_num_threads(1)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


#: LeNet-5's C3 table over 6 input planes: each of the 16 outputs reads
#: 3, 4 or 6 of them (LeCun et al. 1998, table I)
C3 = [[i + 1, o + 1] for o, ins in enumerate(
    [(0, 1, 2), (1, 2, 3), (2, 3, 4), (3, 4, 5), (0, 4, 5), (0, 1, 5),
     (0, 1, 2, 3), (1, 2, 3, 4), (2, 3, 4, 5), (0, 3, 4, 5), (0, 1, 4, 5),
     (0, 1, 2, 5), (0, 1, 3, 4), (1, 2, 4, 5), (0, 2, 3, 5),
     (0, 1, 2, 3, 4, 5)]) for i in ins]
EVEN4 = np.asarray([[1, 2, 2, 1], [2, 4, 4, 2], [2, 4, 4, 2], [1, 2, 2, 1]],
                   np.float32)

#: rois (batch index, x1, y1, x2, y2) on a 2 x 10 x 12 map at scale 0.5:
#: the whole map, inner boxes (x.5 corners rounding half to even), one
#: across the right and bottom border, one off the map (every bin
#: empty), one a single pixel, one on the second image
ROIS = np.asarray([[0, 0, 0, 23, 19], [1, 3, 5, 17, 15], [0, 5, 1, 9, 11],
                   [1, 16, 12, 30, 26], [0, 40, 30, 50, 36],
                   [1, 6, 6, 6, 6], [1, 1, 2, 21, 7]], np.float32)

#: ``{id: ((class name, args, kwargs), input, tolerance)}``
CASES = {
    "SpatialShareConvolution": (("SpatialShareConvolution",
                                 (3, 4, 3, 3, 1, 1, 1, 1), {}),
                                _x(2, 3, 6, 6), TOL),
    "SpatialDilatedConvolution": (("SpatialDilatedConvolution",
                                   (3, 4, 3, 3, 1, 1, 2, 2, 2, 2), {}),
                                  _x(2, 3, 9, 9), TOL),
    "SpatialDilatedConvolution-strided": (
        ("SpatialDilatedConvolution", (2, 3, 3, 2, 2, 1, 1, 0, 3, 1), {}),
        _x(2, 2, 8, 11), TOL),
    "SpatialFullConvolution": (("SpatialFullConvolution",
                                (3, 4, 4, 4, 2, 2, 1, 1), {}),
                               _x(2, 3, 5, 5), TOL),
    "SpatialFullConvolution-3d-input-no-bias": (
        ("SpatialFullConvolution", (3, 2, 3, 3, 2, 2, 1, 1),
         {"no_bias": True}), _x(3, 4, 4), TOL),
    "SpatialFullConvolution-grouped-adj": (
        ("SpatialFullConvolution", (4, 6, 3, 3, 2, 2, 1, 1, 1, 1, 2), {}),
        _x(2, 4, 5, 4), TOL),
    # adj >= stride: PyTorch's output_padding refuses it
    "SpatialFullConvolution-adj-past-stride": (
        ("SpatialFullConvolution", (3, 2, 3, 3, 1, 2, 1, 0, 2, 3), {}),
        _x(2, 3, 4, 5), TOL),
    "VolumetricConvolution": (("VolumetricConvolution",
                               (2, 3, 3, 3, 3, 1, 2, 2, 1, 1, 1), {}),
                              _x(2, 2, 5, 6, 6), TOL_3D),
    "VolumetricFullConvolution": (("VolumetricFullConvolution",
                                   (2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1, 1, 1,
                                    1), {}), _x(1, 2, 3, 4, 4), TOL_3D),
    # n_group is accepted and ignored; adj >= stride on two axes
    "VolumetricFullConvolution-groups-ignored-adj": (
        ("VolumetricFullConvolution", (2, 4, 2, 3, 3, 1, 2, 1, 0, 1, 0, 1,
                                       2, 1, 2), {}),
        _x(2, 3, 4, 2), TOL_3D),
    "SpatialConvolutionMap": (("SpatialConvolutionMap",
                               ([[1, 1], [1, 2], [2, 2]], 3, 3, 1, 1, 1, 1),
                               {}), _x(2, 2, 6, 6), TOL),
    "SpatialConvolutionMap-C3": (("SpatialConvolutionMap",
                                  (np.asarray(C3), 5, 5), {}),
                                 _x(2, 6, 9, 9), TOL),
    "Normalize-p2": (("Normalize", (2.0,), {}), _x(2, 5, 3, 3), TOL),
    "Normalize-p1": (("Normalize", (1.0,), {}), _x(4, 6), TOL),
    "Normalize-p3": (("Normalize", (3.0, 1e-6), {}), _x(4, 6), TOL),
    "Normalize-inf": (("Normalize", (float("inf"),), {}), _x(2, 5, 3, 3),
                      TOL),
    "SpatialSubtractiveNormalization": (
        ("SpatialSubtractiveNormalization", (3,), {}), _x(2, 3, 10, 11),
        TOL),
    "SpatialSubtractiveNormalization-even": (
        ("SpatialSubtractiveNormalization", (3, EVEN4), {}),
        _x(2, 3, 7, 8), TOL),
    "SpatialDivisiveNormalization": (
        ("SpatialDivisiveNormalization", (3,), {}), _x(2, 3, 10, 11), TOL),
    "SpatialDivisiveNormalization-even-threshold": (
        ("SpatialDivisiveNormalization", (2, EVEN4, 0.9, 0.5), {}),
        _x(2, 2, 7, 8), TOL),
    "SpatialContrastiveNormalization": (
        ("SpatialContrastiveNormalization", (3,), {}), _x(2, 3, 10, 11),
        TOL),
    "SpatialContrastiveNormalization-even": (
        ("SpatialContrastiveNormalization", (1, EVEN4), {}),
        _x(2, 1, 9, 6), TOL),
    "TemporalMaxPooling": (("TemporalMaxPooling", (3,), {}), _x(2, 10, 4),
                           TOL),
    "TemporalMaxPooling-strided-2d": (("TemporalMaxPooling", (3, 2), {}),
                                      _x(9, 5), TOL),
    "VolumetricMaxPooling": (("VolumetricMaxPooling", (2, 2, 2), {}),
                             _x(2, 3, 4, 6, 6), TOL),
    "VolumetricMaxPooling-padded": (("VolumetricMaxPooling",
                                     (3, 3, 3, 2, 2, 2, 1, 1, 1), {}),
                                    _x(1, 2, 5, 6, 7), TOL),
    # pad 2 at kernel 3: F.max_pool3d refuses a pad above half the kernel
    "VolumetricMaxPooling-wide-pad": (("VolumetricMaxPooling",
                                       (3, 2, 3, 3, 2, 3, 2, 0, 2), {}),
                                      _x(1, 2, 4, 5, 7), TOL),
    "RoiPooling": (("RoiPooling", (3, 2, 0.5), {}),
                   T(_x(2, 3, 10, 12), ROIS), TOL),
    "RoiPooling-7x7": (("RoiPooling", (7, 7, 0.5), {}),
                       [_x(2, 2, 10, 12, seed=1), ROIS], TOL),
    # integer-valued features: many tied maxima in each window
    "RoiPooling-ties": (("RoiPooling", (2, 3, 1.0), {}),
                        [np.random.default_rng(4).integers(
                            0, 3, (2, 2, 10, 12)).astype(np.float32),
                         ROIS * np.asarray([1, .5, .5, .5, .5], np.float32)],
                        TOL),
}

WITH_PARAMS = ("Convolution",)


def _both(name, args, kw):
    port_kw = dict(kw)
    if name.endswith(WITH_PARAMS) or name == "SpatialConvolutionMap":
        port_kw["generator"] = torch.Generator().manual_seed(1)
    return getattr(jnn, name)(*args, **kw), getattr(nn, name)(*args,
                                                               **port_kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    spec, inp, tol = CASES[case]
    ref, port = _both(*spec)
    assert_table_parity(ref, port, inp, tol, jit=spec[0] != "RoiPooling")


def test_roi_pooling_bins_off_the_map_are_zero_and_pass_no_gradient():
    data = torch.from_numpy(_x(2, 3, 10, 12)).requires_grad_()
    out = nn.RoiPooling(3, 2, 0.5)([data, torch.from_numpy(ROIS)])
    assert out.shape == (len(ROIS), 3, 2, 3)
    assert torch.all(out[4] == 0)           # the roi off the map
    assert torch.all(out[3, :, :, -1] == 0)  # past the right border
    out.sum().backward()
    assert torch.isfinite(data.grad).all()


def test_roi_pooling_chunks_alike(monkeypatch):
    """Rois in chunks of one give what one chunk of all gives."""
    import bigdl_tpu_torch.nn.pool as pool
    inp = [torch.from_numpy(_x(2, 3, 10, 12)), torch.from_numpy(ROIS)]
    whole = nn.RoiPooling(7, 7, 0.5)(inp)
    monkeypatch.setattr(pool, "ROI_CHUNK_ELEMENTS", 1)
    assert torch.equal(nn.RoiPooling(7, 7, 0.5)(inp), whole)


def test_full_convolution_output_sizes_follow_torch_and_adj():
    for args, hw in (((3, 4, 4, 4, 2, 2, 1, 1), (10, 10)),
                     ((3, 2, 3, 3, 1, 2, 1, 0, 2, 3), (14, 7))):
        m = nn.SpatialFullConvolution(*args)
        assert tuple(m(torch.zeros(1, 3, 5, 5)).shape[2:]) == hw


def test_convolution_map_masks_unconnected_weights():
    m = nn.SpatialConvolutionMap(np.asarray(C3), 5, 5,
                                 generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(_x(2, 6, 9, 9))
    m(x).sum().backward()
    mask = np.zeros((16, 6), bool)
    for i, o in C3:
        mask[o - 1, i - 1] = True
    g = m.weight.grad.abs().sum(dim=(2, 3)).numpy()
    assert np.all(g[~mask] == 0) and np.all(g[mask] > 0)
    # fan-in is 6 connections x 25 taps (the widest output)
    assert m.weight.abs().max().item() <= 1.0 / np.sqrt(6 * 25)


def test_regularizers_reach_the_penalty_where_the_jax_package_adds_one():
    """The JAX package's ``VolumetricConvolution`` keeps its regularizers
    and adds no penalty; ``SpatialFullConvolution`` and
    ``SpatialDilatedConvolution`` add theirs. The port mirrors both."""
    for name, args in (("VolumetricConvolution", (2, 3, 3, 3, 3)),
                       ("SpatialFullConvolution", (2, 3, 3, 3)),
                       ("SpatialDilatedConvolution", (2, 3, 3, 3))):
        ref = getattr(jnn, name)(*args, w_regularizer=JL2(0.1))
        port = getattr(nn, name)(*args, w_regularizer=L2Regularizer(0.1),
                                 generator=torch.Generator().manual_seed(1))
        ref.set_parameters(jax.tree.map(np.asarray, port.get_parameters()))
        got = port.regularization_loss()
        want = float(ref.regularization_loss(ref.get_parameters()))
        got = got.item() if torch.is_tensor(got) else got
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (want == 0.0) == (name == "VolumetricConvolution")


def test_gaussian_kernel_is_the_jax_packages():
    from bigdl_tpu.nn.norm import _gaussian_kernel_2d as jax_kernel
    for k in (4, 9):
        np.testing.assert_allclose(_gaussian_kernel_2d(k).numpy(),
                                   np.asarray(jax_kernel(k)), rtol=1e-6,
                                   atol=1e-8)


SPEC_CASES = {
    "SpatialConvolutionMap-list": ("SpatialConvolutionMap",
                                   ([[1, 1], [1, 2], [2, 2]], 3, 3), {}),
    "SpatialConvolutionMap-array": ("SpatialConvolutionMap",
                                    (np.asarray(C3), 5, 5, 1, 1, 2, 2), {}),
    "SpatialSubtractiveNormalization-kernel": (
        "SpatialSubtractiveNormalization", (3, EVEN4), {}),
    "SpatialDivisiveNormalization-kernel": (
        "SpatialDivisiveNormalization", (2,), {"kernel": EVEN4,
                                               "threshold": 0.5}),
    "SpatialContrastiveNormalization-kernel": (
        "SpatialContrastiveNormalization", (1, EVEN4), {}),
    "SpatialFullConvolution": ("SpatialFullConvolution",
                               (4, 6, 3, 3, 2, 2, 1, 1, 1, 1, 2),
                               {"no_bias": True}),
    "VolumetricFullConvolution": ("VolumetricFullConvolution",
                                  (2, 3, 3, 3, 3), {"n_group": 2}),
    "RoiPooling": ("RoiPooling", (7, 7, 0.0625), {}),
    "VolumetricMaxPooling": ("VolumetricMaxPooling", (3, 3, 3, 2), {}),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_equals_jax_and_round_trips(case):
    """Both serializers write one spec (array arguments as the same
    ``__ndarray__`` with its dtype), and each package rebuilds it."""
    ref, port = _both(*SPEC_CASES[case])
    spec = ms.to_spec(port)
    assert json.loads(json.dumps(spec)) == spec
    assert spec == json.loads(json.dumps(jms.to_spec(ref)))
    rebuilt = ms.from_spec(spec)
    assert type(rebuilt) is type(port) and ms.to_spec(rebuilt) == spec
    assert jms.to_spec(jms.from_spec(spec)) == jms.to_spec(ref)
