"""The port's LBFGS and strong-Wolfe line search against the JAX
package's (``tests/test_lbfgs.py``'s five cases, each run by both
packages on the same problem): the same assertions on the port's
result, and the port's ``f`` history and minimizer beside the JAX
package's.

Tolerance: float32 in both packages, so the two trajectories agree to
float32 rounding where the line search takes the same branches. The
``f`` histories agree within 1e-4 of the first value (the objective's
own scale), whole and of equal length for the quadratic and the fixed
step, over the first 10 iterations for Rosenbrock and 8 for the
regression (there a last-bit difference later moves a line-search
branch: on Rosenbrock the runs end 42 and 43 values long at the same
minimum); the minimizers agree within the JAX test's own tolerance of
the exact minimum. The cubic interpolation is host Python in both:
bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import LBFGS as JaxLBFGS
from bigdl_tpu.optim import lbfgs as jlbfgs
from bigdl_tpu_torch.optim import LBFGS
from bigdl_tpu_torch.optim import lbfgs as plbfgs


def _port_feval(fn):
    """``feval`` for the port: ``fn`` of torch tensors (a tensor, or a
    dict of them) -> scalar, with its gradient by autograd."""
    def feval(x):
        if isinstance(x, dict):
            leaves = {k: v.detach().requires_grad_() for k, v in x.items()}
            f = fn(leaves)
            grads = torch.autograd.grad(f, list(leaves.values()))
            return f.detach(), dict(zip(leaves, grads))
        x = x.detach().requires_grad_()
        f = fn(x)
        (g,) = torch.autograd.grad(f, x)
        return f.detach(), g
    return feval


def _assert_histories_close(got, want):
    assert len(got) == len(want), (len(got), len(want))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, abs(want[0])))


def _quadratic(lib, diag, c):
    a = lib.asarray(np.diag(diag).astype(np.float32)) if lib is jnp else \
        torch.from_numpy(np.diag(diag).astype(np.float32))
    cc = lib.asarray(np.asarray(c, np.float32)) if lib is jnp else \
        torch.tensor(c, dtype=torch.float32)

    def f(x):
        d = x - cc
        return d @ a @ d
    return f


def test_quadratic_converges_as_in_jax():
    """f(x) = (x - c)' A (x - c): the exact minimum, as the JAX test."""
    diag, c = [1.0, 10.0, 100.0], [1.0, -2.0, 3.0]
    jf = _quadratic(jnp, diag, c)
    jx, jh = JaxLBFGS(max_iter=50, max_eval=200).optimize(
        jax.jit(jax.value_and_grad(jf)), jnp.zeros(3, jnp.float32))
    pf = _quadratic(torch, diag, c)
    px, ph = LBFGS(max_iter=50, max_eval=200).optimize(
        _port_feval(pf), torch.zeros(3))
    assert ph[0] == pytest.approx(float(pf(torch.zeros(3))), rel=1e-5)
    assert ph[-1] < ph[0]
    np.testing.assert_allclose(px.numpy(), c, atol=1e-3)
    _assert_histories_close(ph, jh)
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-3)


def test_rosenbrock_converges_as_in_jax():
    def rosen(x):
        return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()

    x0 = [-1.2, 1.0, -1.2, 1.0]
    kw = dict(max_iter=200, max_eval=1000, tol_fun=1e-10, tol_x=1e-12)
    jx, jh = JaxLBFGS(**kw).optimize(
        jax.jit(jax.value_and_grad(lambda x: jnp.sum(
            100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2))),
        jnp.asarray(x0, jnp.float32))
    px, ph = LBFGS(**kw).optimize(_port_feval(rosen), torch.tensor(x0))
    assert ph[-1] < 1e-4
    np.testing.assert_allclose(px.numpy(), 1.0, atol=2e-2)
    # the first iterations follow the JAX package's until float32
    # rounding moves a line-search branch; both reach the minimum
    _assert_histories_close(ph[:10], jh[:10])
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=2e-2)


def test_fixed_step_without_line_search_as_in_jax():
    jx, jh = JaxLBFGS(max_iter=30, learning_rate=0.3,
                      line_search=None).optimize(
        jax.jit(jax.value_and_grad(lambda x: jnp.sum(x ** 2))),
        jnp.ones(4, jnp.float32) * 3)
    px, ph = LBFGS(max_iter=30, learning_rate=0.3, line_search=None) \
        .optimize(_port_feval(lambda x: (x ** 2).sum()), torch.ones(4) * 3)
    assert ph[-1] < 1e-4
    _assert_histories_close(ph, jh)


def test_dict_parameters_as_the_jax_pytree_case():
    """A dict of tensors (a tiny linear regression), as the JAX test's
    pytree: the result comes back as a dict of the same shapes."""
    rng = np.random.RandomState(0)
    x = rng.randn(32, 5).astype(np.float32)
    w_true = rng.randn(5).astype(np.float32)
    y = x @ w_true + 0.7
    kw = dict(max_iter=100, max_eval=500, tol_fun=1e-12)

    def jloss(p):
        return jnp.mean((jnp.asarray(x) @ p["w"] + p["b"] - y) ** 2)

    jp, jh = JaxLBFGS(**kw).optimize(
        jax.jit(jax.value_and_grad(jloss)),
        {"w": jnp.zeros(5, jnp.float32), "b": jnp.zeros((), jnp.float32)})
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    pp, ph = LBFGS(**kw).optimize(
        _port_feval(lambda p: ((xt @ p["w"] + p["b"] - yt) ** 2).mean()),
        {"w": torch.zeros(5), "b": torch.zeros(())})
    assert set(pp) == {"w", "b"} and pp["b"].shape == ()
    assert ph[-1] < 1e-6
    np.testing.assert_allclose(pp["w"].numpy(), w_true, atol=1e-2)
    assert float(pp["b"]) == pytest.approx(0.7, abs=1e-2)
    _assert_histories_close(ph[:8], jh[:8])
    np.testing.assert_allclose(pp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-2)


def test_reentry_matches_a_single_run_as_in_jax():
    """Two ``optimize()`` calls of 4 iterations follow one call of 8
    (the last step length persists as ``stepLen``), in the port as in
    the JAX package, and the two packages' results agree."""
    diag, c, x0 = [1.0, 25.0, 400.0], [0.5, -1.5, 2.0], [4.0, 4.0, 4.0]
    jfe = jax.jit(jax.value_and_grad(_quadratic(jnp, diag, c)))
    jwhole, _ = JaxLBFGS(max_iter=8, max_eval=400).optimize(
        jfe, jnp.asarray(x0, jnp.float32))
    pfe = _port_feval(_quadratic(torch, diag, c))
    whole, _ = LBFGS(max_iter=8, max_eval=400).optimize(pfe,
                                                        torch.tensor(x0))
    split = LBFGS(max_iter=4, max_eval=400)
    mid, _ = split.optimize(pfe, torch.tensor(x0))
    assert {"stepLen", "dir", "prevGrad", "Hdiag", "nIter", "funcEval",
            "old_dirs"} <= set(split.state)
    assert split.state["nIter"] == 4
    again, _ = split.optimize(pfe, mid)
    np.testing.assert_allclose(again.numpy(), whole.numpy(), atol=1e-5)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jwhole), atol=1e-4)


@pytest.mark.parametrize("args", [
    (0.0, 1.0, -2.0, 1.0, 0.5, 1.5),
    (2.0, 0.3, 0.4, 0.5, 0.9, -1.0),
    (0.0, 1.0, -1.0, 1.0, 3.0, 3.0),       # no real root: the midpoint
    (1.0, 2.0, -0.5, 4.0, 1.0, 0.25, (1.5, 3.0))])
def test_cubic_interpolation_is_the_jax_packages(args):
    bounds = args[6] if len(args) > 6 else None
    assert plbfgs._cubic_interpolate(*args[:6], bounds=bounds) == \
        jlbfgs._cubic_interpolate(*args[:6], bounds=bounds)


def test_update_raises_as_in_jax():
    with pytest.raises(NotImplementedError):
        JaxLBFGS().update(None, {}, None, 0.1)
    with pytest.raises(NotImplementedError):
        LBFGS().update([torch.zeros(1)], {}, [torch.zeros(1)], 0.1)
    with pytest.raises(ValueError):
        LBFGS(line_search="armijo")
