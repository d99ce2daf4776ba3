"""Dropout in the port against the JAX package: ``Dropout``,
``SpatialDropout2D`` and ``L1Penalty`` in both modes, attention dropout
(outputs and gradients, the kernel bypass, no draw without a
generator), a dropout TransformerLM's forward and one train step, and
the errors without a generator.

JAX's threefry ``bernoulli`` and torch's Philox draw different masks, so
both packages get the same numpy masks: ``jax.random.bernoulli`` is
patched in the JAX package (test-only; nothing under ``bigdl_tpu/``
changes) and the port's one draw site, ``nn.dropout.keep_mask``, in the
port. Each patch hands out the masks of one seeded numpy stream in call
order. Tolerance: float32, 1e-5 on outputs, losses and parameters and
1e-4 on gradients (the JAX package's float32 contract); the masked
layers alone are bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn.attention import \
    dot_product_attention as jax_dot_product_attention
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim.optimizer import build_train_step as jax_build_step
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import kernels
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.nn import dropout as pdropout
from bigdl_tpu_torch.nn.attention import dot_product_attention
from bigdl_tpu_torch.optim import SGD, build_train_step

from _torch_parity import assert_trees_close

ATOL = 1e-5
GRAD_ATOL = 1e-4
P = 0.25
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=16)
SEQ, BATCH = 16, 4


class Masks:
    """One seeded numpy stream of keep masks, handed out in call order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def draw(self, shape, p):
        self.shapes.append(tuple(shape))
        return self.rng.random(tuple(shape)) < (1.0 - p)


@pytest.fixture
def same_masks(monkeypatch):
    """Patch both draw sites with the same seeded stream; returns the
    two recorders (JAX's, the port's)."""
    jm, pm = Masks(5), Masks(5)
    monkeypatch.setattr(
        jax.random, "bernoulli",
        lambda key, p_keep, shape: jnp.asarray(jm.draw(shape, 1 - p_keep)))
    monkeypatch.setattr(
        pdropout, "keep_mask",
        lambda shape, p, generator: torch.from_numpy(pm.draw(shape, p)))
    return jm, pm


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------------- the layers

@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("layer", ["Dropout", "Dropout scale=False",
                                   "SpatialDropout2D"])
def test_dropout_layers_match_jax(layer, training, same_masks):
    """Forward and input gradient of each layer, patched masks, both
    modes: bitwise the JAX layer (evaluation: the identity, or ``x * (1
    - p)`` unscaled)."""
    name, _, opt = layer.partition(" ")
    kw = {"scale": False} if opt else {}
    ref = getattr(jnn, name)(P, **kw)
    port = getattr(nn, name)(P, **kw)
    if not training:
        port.evaluate()
    x = _x((3, 5, 4, 4))
    g = _x((3, 5, 4, 4), seed=1)

    def f(xj):
        return ref.forward_fn({}, xj, training=training,
                              rng=jax.random.PRNGKey(0))
    want, vjp = jax.vjp(f, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, generator=torch.Generator())
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
    if name == "SpatialDropout2D" and training:
        assert same_masks[1].shapes == [(3, 5, 1, 1)]


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("size_average", [False, True])
def test_l1_penalty_matches_jax(size_average, training):
    """The identity forward, and ``g + lam * sign(x)`` backward in
    training (``lam / numel`` under ``size_average``), the plain
    gradient in evaluation."""
    ref = jnn.L1Penalty(0.3, size_average=size_average)
    port = nn.L1Penalty(0.3, size_average=size_average)
    if not training:
        port.evaluate()
    x = _x((4, 6))
    x[0, 0] = 0.0                       # sign(0) = 0 in both
    g = _x((4, 6), seed=2)
    want, vjp = jax.vjp(lambda xj: ref.forward_fn(
        {}, xj, training=training), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=1e-7, rtol=0)


def test_training_without_a_generator_raises():
    x = torch.ones(2, 3, 4, 4)
    for layer in (nn.Dropout(0.5), nn.SpatialDropout2D(0.5)):
        with pytest.raises(ValueError, match="generator"):
            layer(x)
        assert torch.equal(layer.evaluate()(x), x)
    # p = 0 draws nothing and needs no generator, as in the JAX package
    assert torch.equal(nn.Dropout(0.0)(x), x)


def test_keep_mask_draws_on_its_generator():
    """Bernoulli(1 - p) on the generator's device: the same seed gives the
    same mask, another seed another, and the keep fraction is within 4
    sigma of 1 - p."""
    def mask(seed):
        return pdropout.keep_mask((256, 256), 0.1,
                                  torch.Generator().manual_seed(seed))
    a, b, c = mask(3), mask(3), mask(4)
    assert a.dtype == torch.bool and torch.equal(a, b)
    assert not torch.equal(a, c)
    n = a.numel()
    assert abs(a.float().mean().item() - 0.9) <= 4 * (0.09 / n) ** 0.5


# ------------------------------------------------------------ attention

@pytest.mark.parametrize("causal", [True, False])
def test_attention_dropout_matches_jax(causal, same_masks):
    """``dot_product_attention`` in training at rate 0.25 with the same
    masks: outputs and q/k/v gradients."""
    q, k, v = (_x((2, 4, SEQ, 8), seed=s) for s in range(3))
    g = _x((2, 4, SEQ, 8), seed=3)

    def f(qj, kj, vj):
        return jax_dot_product_attention(
            qj, kj, vj, causal=causal, dropout_rate=P,
            rng=jax.random.PRNGKey(1), training=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = dot_product_attention(*ts, causal=causal, dropout_rate=P,
                                generator=torch.Generator(), training=True)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    for t, w in zip(ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=0)
    assert same_masks[0].shapes == same_masks[1].shapes == \
        [(2, 4, SEQ, SEQ)]


def test_attention_dropout_bypasses_the_kernels(monkeypatch):
    """In training at a rate above 0 neither kernel route is tried (the
    JAX package's rule); in evaluation, or at rate 0, the dispatch
    is."""
    calls = []
    real = kernels.attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(kernels, "attention", spy)
    q = torch.from_numpy(_x((1, 2, SEQ, 8)))
    gen = torch.Generator()
    dot_product_attention(q, q, q, causal=True, dropout_rate=P,
                          generator=gen, training=True)
    assert calls == []
    dot_product_attention(q, q, q, causal=True, dropout_rate=P,
                          generator=gen, training=False)
    dot_product_attention(q, q, q, causal=True, dropout_rate=0.0,
                          generator=gen, training=True)
    assert calls == [1, 1]


def test_attention_without_a_generator_draws_nothing():
    """The JAX package draws only with an ``rng``; the port only with a
    generator: the einsum path's output, undropped."""
    q, k, v = (torch.from_numpy(_x((1, 2, SEQ, 8), seed=s))
               for s in range(3))
    got = dot_product_attention(q, k, v, causal=True, dropout_rate=P,
                                training=True)
    with kernels.use(kernels.KernelConfig.off()):
        want = dot_product_attention(q, k, v, causal=True)
    assert torch.equal(got, want)


# ---------------------------------------------------------- the model

def _models(seed=6, **kw):
    JaxRandomGenerator.set_seed(seed)
    ref = JaxTransformerLM(**GEOM, **kw)
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = load_jax_params(TransformerLM(**GEOM, **kw, device="cpu"),
                           params)
    return ref, params, port


def _batch():
    x, y = transformer_train.synthetic_corpus(2000, GEOM["vocab_size"], SEQ,
                                              "packed", BATCH)
    return [p[:BATCH] for p in x], y[:BATCH]


def test_dropout_lm_forward_matches_jax(same_masks):
    """A training forward of the packed batch through a dropout-0.1
    TransformerLM: one mask a layer, the same in both packages."""
    ref, params, port = _models(dropout=0.1)
    x, _ = _batch()
    want, _ = ref.apply(jax.tree.map(jnp.asarray, params), ref.get_state(),
                        [jnp.asarray(p) for p in x], training=True,
                        rng=jax.random.PRNGKey(2))
    got = port([torch.from_numpy(p) for p in x],
               generator=torch.Generator())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    assert same_masks[1].shapes == [(BATCH, 4, SEQ, SEQ)] * 2
    assert same_masks[0].shapes == same_masks[1].shapes


def test_dropout_lm_eval_forward_is_the_dropout_free_models():
    """Evaluation mode draws nothing: the dropout model's logits are a
    dropout-0 model's with the same weights, bitwise."""
    _, params, port = _models(dropout=0.3)
    plain = load_jax_params(TransformerLM(**GEOM, device="cpu"), params)
    x, _ = _batch()
    planes = [torch.from_numpy(p) for p in x]
    with torch.no_grad():
        assert torch.equal(port.evaluate()(planes), plain.evaluate()(planes))


def test_dropout_train_step_matches_jax(same_masks):
    """Two SGD steps of the dropout model through each package's
    ``build_train_step`` (the port's own generator, the JAX step's rng;
    both patched to the same masks): losses and parameters. The patched
    masks are constants of the JAX step's trace, so its step is built
    anew for each step (one trace, one pair of masks, each)."""
    ref, params, port = _models(seed=7, dropout=0.1)
    x, y = _batch()
    crit = dict(ignore_index=-1)
    p_step = build_train_step(port, nn.SequenceCrossEntropyCriterion(
        **crit), SGD(learning_rate=0.1))
    assert p_step.generator is not None
    j_params = jax.tree.map(jnp.asarray, params)
    j_opt, m_state = JaxSGD(learning_rate=0.1).init_state(j_params), \
        ref.get_state()
    for i in range(2):
        j_step = jax_build_step(
            ref, jnn.SequenceCrossEntropyCriterion(**crit),
            JaxSGD(learning_rate=0.1))
        j_params, j_opt, m_state, j_loss = j_step(
            j_params, j_opt, m_state, jax.random.PRNGKey(i), 0.1,
            [jnp.asarray(p) for p in x], jnp.asarray(y))
        p_loss = p_step([torch.from_numpy(p) for p in x],
                        torch.from_numpy(y), 0.1)
        assert abs(float(p_loss) - float(j_loss)) <= ATOL
    assert_trees_close(export_params(port), jax.tree.map(np.asarray,
                                                         j_params), ATOL)
    assert len(same_masks[1].shapes) == 4


def test_step_generator_follows_the_seed():
    """The step's generator is seeded from ``RandomGenerator``: one seed
    gives the same masks and losses, another seed other losses."""
    from bigdl_tpu_torch.utils.random import RandomGenerator

    def losses(seed):
        _, _, port = _models(seed=8, dropout=0.2)
        RandomGenerator.set_seed(seed)
        step = build_train_step(port, nn.SequenceCrossEntropyCriterion(
            ignore_index=-1), SGD(learning_rate=0.1))
        x, y = _batch()
        return [float(step([torch.from_numpy(p) for p in x],
                           torch.from_numpy(y), 0.1)) for _ in range(2)]
    try:
        a, b, c = losses(11), losses(11), losses(12)
    finally:
        RandomGenerator.set_seed(1)
    assert a == b and a != c
