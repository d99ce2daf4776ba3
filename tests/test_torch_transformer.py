"""The port's TransformerLM against the JAX package's on the same
weights: ``load_jax_params`` carries the JAX param tree over, then the
full forward, a cached prefill and three ragged decode steps must agree.

Tolerance: float32 atol 1e-5 on logits and caches — the JAX package's
own decode-vs-forward contract; the frameworks reduce in other orders
and the port's decode step always takes the ragged kernel's plain
version, while the JAX einsum path scales after the product."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import kernels as jax_kernels
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn.norm import LayerNorm as JaxLayerNorm
from bigdl_tpu.utils.random import RandomGenerator
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.nn import LayerNorm

ATOL = 1e-5
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=32)


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(7)
    ref = JaxTransformerLM(**GEOM).evaluate()
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = load_jax_params(TransformerLM(**GEOM, device="cpu"), params)
    return ref, params, port


def test_layernorm_matches_jax():
    x = np.random.default_rng(0).standard_normal((4, 5, 32)) \
        .astype(np.float32) * 3 + 1
    w = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    b = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    want = JaxLayerNorm(32).forward_fn({"weight": jnp.asarray(w),
                                        "bias": jnp.asarray(b)},
                                       jnp.asarray(x))
    ln = LayerNorm(32)
    load_jax_params(ln, {"weight": w, "bias": b})
    with torch.no_grad():
        got = ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert np.abs(exact.numpy() - want).max() > 1e-4  # erf form differs


def test_converter_refuses_a_mismatched_tree(pair):
    _, params, _ = pair
    port = TransformerLM(**GEOM, device="cpu")
    short = {k: v for k, v in params.items() if k != "pos_embed"}
    with pytest.raises(KeyError, match="pos_embed"):
        load_jax_params(port, short)
    bad = dict(params, embed=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="embed"):
        load_jax_params(port, bad)


def test_full_forward_matches_jax(pair):
    ref, params, port = pair
    tokens = np.random.default_rng(3).integers(0, 64, (3, 32)) \
        .astype(np.int32)
    want, _ = ref.apply(params, ref.get_state(), jnp.asarray(tokens))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _cache(batch, dtype=np.float32):
    shape = (GEOM["num_layers"], batch, GEOM["num_heads"], GEOM["max_len"],
             GEOM["hidden_size"] // GEOM["num_heads"])
    return np.zeros(shape, dtype)


@pytest.mark.parametrize("jax_decode_kernel", [False, True],
                         ids=["jax_einsum", "jax_pallas_interpret"])
def test_cached_prefill_and_ragged_decode_match_jax(pair,
                                                    jax_decode_kernel):
    """Prefill three ragged prompts (lengths 3, 8, 5; attend 8) into a
    32-long cache, then three decode steps at positions 3/8/5 + i over
    a 16-wide attend window — a non-contiguous view of the port's
    cache. The JAX side runs its decode step through the einsum path,
    or through its Pallas kernel in interpret mode."""
    ref, params, port = pair
    state = ref.get_state()
    lens = np.array([3, 8, 5], np.int32)
    r = np.random.default_rng(4)
    prompts = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = r.integers(1, 64, n)
    zeros = np.zeros(3, np.int32)
    cfg = (jax_kernels.KernelConfig(decode_attention=True, interpret=True)
           if jax_decode_kernel else jax_kernels.KernelConfig.off())

    # the kernel config is read while tracing, so each config traces
    # its own program (one per attend_len)
    apply = jax.jit(lambda p, t, c, pos, attend_len: ref.apply(
        p, state, t, cache=c, positions=pos, attend_len=attend_len),
        static_argnames="attend_len")
    with jax_kernels.use(cfg):
        jlog, _, jcache = apply(
            params, jnp.asarray(prompts),
            {"k": jnp.asarray(_cache(3)), "v": jnp.asarray(_cache(3))},
            jnp.asarray(zeros), attend_len=8)
    tcache = {"k": torch.from_numpy(_cache(3)),
              "v": torch.from_numpy(_cache(3))}
    with torch.no_grad():
        tlog = port(torch.from_numpy(prompts), cache=tcache,
                    positions=torch.from_numpy(zeros), attend_len=8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)

    last = np.asarray(jlog)[np.arange(3), lens - 1]
    for step in range(3):
        tokens = last.argmax(-1).astype(np.int32)[:, None]
        pos = lens + step
        with jax_kernels.use(cfg):
            jlog, _, jcache = apply(params, jnp.asarray(tokens), jcache,
                                    jnp.asarray(pos), attend_len=16)
        with torch.no_grad():
            tlog = port(torch.from_numpy(tokens), cache=tcache,
                        positions=torch.from_numpy(pos), attend_len=16)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{name} cache, step {step}")
        last = np.asarray(jlog)[:, 0]
