"""The LM layers of the TransformerLM training slice, the port against the
JAX package: the MoE layer (forward, load-balance term, ``expert_frac``
and gradients), one ``LocalOptimizer`` step of an MoE TransformerLM
with the load-balance term in the objective, MoE checkpoints resumed
across packages, windows of an MoE dropout model, the untied head,
module snapshots of either package loaded by the other, and RMSNorm.

Tolerances (float32 unless stated): outputs and losses 1e-5 (losses
relative), parameters 1e-5, gradients 1e-4 absolute, the MoE's routing
fractions exact (one-hot means of the same routing); RMSNorm in
bfloat16 within one bfloat16 rounding (2^-8 relative: both packages
round the same float32 statistics, summed in other orders). Inputs are
seeded normals, where ties among the router's probabilities, which the
two top-k implementations could order differently, do not occur."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.models.transformer import TransformerLM as JaxTransformerLM
from bigdl_tpu.nn.moe import MoE as JaxMoE
from bigdl_tpu.nn.module import AUX_LOSS_KEY as JAX_AUX_KEY
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.convert import export_params, export_state, \
    load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.nn.moe import AUX_LOSS_KEY, pop_aux_losses
from bigdl_tpu_torch.utils import serialization as pser
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close, flat, to_jax

ATOL = 1e-5
GRAD_ATOL = 1e-4
GEOM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_len=16, moe_experts=4)
SEQ, BATCH = 16, 4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("top_k,activation", [(2, "gelu"), (1, "relu"),
                                              (3, "gelu")])
def test_moe_matches_jax(top_k, activation):
    """Forward, the load-balance term, ``expert_frac`` and the gradients
    of ``sum(out * g) + 0.01 * aux`` with respect to the input and the
    three weights."""
    ref = JaxMoE(32, 48, 4, top_k=top_k, activation=activation)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(3)))
    port = nn.MoE(32, 48, 4, top_k=top_k, activation=activation)
    port.set_parameters(params)
    x, g = _x((BATCH, SEQ, 32)), _x((BATCH, SEQ, 32), seed=1)

    def objective(p, xj):
        out, st = ref.apply(p, ref.initial_state(), xj, training=True)
        return jnp.sum(out * jnp.asarray(g)) + 0.01 * st[JAX_AUX_KEY], \
            (out, st)
    (_, (want, st)), (gp, gx) = jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True)(to_jax(params),
                                                 jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    (got * torch.from_numpy(g)).sum().add(0.01 * port.aux_term).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    state = port.get_state()
    np.testing.assert_allclose(state[AUX_LOSS_KEY],
                               np.asarray(st[JAX_AUX_KEY]), rtol=ATOL)
    np.testing.assert_array_equal(state["expert_frac"],
                                  np.asarray(st["expert_frac"]))
    assert abs(state["expert_frac"].sum() - 1.0) < 1e-6
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=0)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_a_trained_moe_copies_and_pickles():
    """After a training forward the layer holds its differentiable term
    until ``pop_aux_losses`` takes it (summed, and cleared on the
    layer); then ``copy.deepcopy`` and ``pickle`` take the layer and
    keep its weights and buffers."""
    import copy
    import pickle

    port = nn.MoE(8, 16, 4)
    port(torch.from_numpy(_x((2, 3, 8))).requires_grad_())
    term = port.aux_term
    assert term.grad_fn is not None
    popped = pop_aux_losses(port)
    assert popped is term and port.aux_term is None
    assert pop_aux_losses(port) == 0.0
    for twin in (copy.deepcopy(port), pickle.loads(pickle.dumps(port))):
        assert twin.aux_term is None
        for a, b in zip([*port.parameters(), *port.buffers()],
                        [*twin.parameters(), *twin.buffers()]):
            assert torch.equal(a, b)


def test_moe_evaluation_forward_keeps_the_buffers():
    port = nn.MoE(8, 16, 4)
    port.evaluate()(torch.from_numpy(_x((2, 3, 8))))
    assert not port.expert_frac.any() and float(port.get_buffer(
        AUX_LOSS_KEY)) == 0.0
    assert port.aux_term is not None     # the term itself is computed


# ------------------------------------------------------------ the model

def _weights(seed=6, **kw):
    JaxRandomGenerator.set_seed(seed)
    ref = JaxTransformerLM(**{**GEOM, **kw})
    ref.ensure_initialized()
    return ref, jax.tree.map(np.asarray, ref.get_parameters())


def _port(params, **kw):
    return load_jax_params(TransformerLM(**{**GEOM, **kw}, device="cpu"),
                           params)


def _rows(n=BATCH):
    x, y = transformer_train.synthetic_corpus(
        2000, GEOM["vocab_size"], SEQ, "packed", BATCH)
    return [([p[i] for p in x], y[i]) for i in range(n)]


def test_moe_lm_layout_and_trees_match_jax():
    """Block 1 of 2 is the MoE block (``i % 2 == 1``); the parameter and
    state trees have the JAX package's names and shape, the untied head
    included."""
    ref, params = _weights(tie_embeddings=False)
    port = _port(params, tie_embeddings=False)
    assert isinstance(port.block_1.mlp, nn.MoE)
    assert not isinstance(port.block_0.mlp, nn.MoE)
    assert port.lm_head.shape == (32, 64)
    assert sorted(flat(export_params(port))) == sorted(flat(params))
    want_state = jax.tree.map(np.asarray, ref.get_state())
    got_state = export_state(port)
    assert got_state.keys() == want_state.keys()
    assert got_state["block_0"] == {"mlp": {}}
    assert sorted(got_state["block_1"]["mlp"]) == \
        sorted(want_state["block_1"]["mlp"])


@pytest.mark.parametrize("tie", [True, False])
def test_moe_lm_forward_matches_jax(tie):
    ref, params = _weights(seed=7, tie_embeddings=tie, dropout=0.1)
    port = _port(params, tie_embeddings=tie, dropout=0.1).evaluate()
    rows = _rows()
    x = [np.stack([r[0][i] for r in rows]) for i in range(3)]
    want, _ = ref.apply(to_jax(params), ref.get_state(),
                        [jnp.asarray(p) for p in x])
    with torch.no_grad():
        got = port([torch.from_numpy(p) for p in x])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _optimizer(pkg, model, rows, steps, ckdir=None, every=2, k=1):
    if pkg == "jax":
        ds = JaxDataSet.array([JaxSample(*r) for r in rows]) \
            .transform(JaxSampleToMiniBatch(BATCH))
        opt = joptim.LocalOptimizer(
            model, ds, jnn.SequenceCrossEntropyCriterion(ignore_index=-1),
            batch_size=BATCH)
        o, rg = joptim, JaxRandomGenerator
    else:
        ds = DataSet.array([Sample(*r) for r in rows]) \
            .transform(SampleToMiniBatch(BATCH))
        opt = optim.LocalOptimizer(
            model, ds, nn.SequenceCrossEntropyCriterion(ignore_index=-1),
            batch_size=BATCH)
        o, rg = optim, RandomGenerator
        opt.set_steps_per_sync(k)
    rg.set_seed(4)
    opt.set_optim_method(o.SGD(learning_rate=0.1))
    opt.set_end_when(o.max_iteration(steps))
    if ckdir is not None:
        opt.set_checkpoint(str(ckdir), o.several_iteration(every))
    return opt


def test_one_optimizer_step_with_the_aux_loss_matches_jax():
    """One ``LocalOptimizer`` SGD step of the MoE TransformerLM (the
    load-balance term at the default weight 0.01 in both objectives):
    the loss, the parameters after, the step's gradients (against
    ``jax.grad`` of the JAX step's objective on the same rows) and the
    MoE state."""
    ref, params = _weights(seed=8)
    port = _port(params)
    rows = _rows()
    j_opt = _optimizer("jax", ref, rows, 1)
    j_opt.optimize()
    p_opt = _optimizer("port", port, rows, 1)
    p_opt.optimize()
    j_loss, p_loss = j_opt.driver_state["Loss"], p_opt.driver_state["Loss"]
    assert abs(p_loss - j_loss) <= ATOL * abs(j_loss)
    assert_trees_close(export_params(port),
                       jax.tree.map(np.asarray, ref.get_parameters()), ATOL)
    assert_trees_close(export_state(port),
                       jax.tree.map(np.asarray, ref.get_state()), 1e-6)

    x = [jnp.asarray(np.stack([r[0][i] for r in rows])) for i in range(3)]
    y = jnp.asarray(np.stack([r[1] for r in rows]))
    crit = jnn.SequenceCrossEntropyCriterion(ignore_index=-1)

    def objective(p):
        out, st = ref.apply(p, ref.initial_state(), x, training=True)
        return crit.apply(out, y) + 0.01 * ref.aux_loss(st)
    want = jax.grad(objective)(to_jax(params))
    got = {name: p.grad for name, p in port.named_parameters()}
    for name, g in flat(want).items():
        np.testing.assert_allclose(got[name].numpy(), g, atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)
    router = got["block_1.mlp.router"]
    assert float(router.abs().max()) > 0


def test_aux_loss_weight_reaches_the_router():
    """The load-balance term is in the objective: weight 0 and 0.01 give
    other router gradients, the same expert-weight gradients' shape, and
    the returned loss is the data loss either way; the step leaves no
    term on the model."""
    _, params = _weights(seed=9)
    rows = _rows()
    x = [torch.from_numpy(np.stack([r[0][i] for r in rows]))
         for i in range(3)]
    y = torch.from_numpy(np.stack([r[1] for r in rows]))
    out = {}
    for w in (0.0, 0.01):
        port = _port(params)
        step = optim.build_train_step(
            port, nn.SequenceCrossEntropyCriterion(ignore_index=-1),
            optim.SGD(learning_rate=0.1), aux_loss_weight=w)
        out[w] = (float(step(x, y, 0.1)),
                  port.block_1.mlp.router.grad.clone())
        assert port.block_1.mlp.aux_term is None
    assert out[0.0][0] == out[0.01][0]
    assert not torch.equal(out[0.0][1], out[0.01][1])


def test_windows_of_an_moe_dropout_model_are_the_per_step_loop():
    """K = 4 windows (step by step on the CPU) against the per-step loop
    over 8 steps of an MoE, dropout-0.1, untied model: losses,
    parameters and buffers bitwise (one generator, one seed)."""
    _, params = _weights(seed=10, tie_embeddings=False)
    rows = _rows(8)
    runs = []
    for k in (4, 1):
        port = _port(params, tie_embeddings=False, dropout=0.1)
        opt = _optimizer("port", port, rows, 8, k=k)
        opt.optimize()
        runs.append(([h["loss"] for h in opt.history],
                     [t.clone() for t in port.parameters()],
                     [t.clone() for t in port.buffers()]))
    (la, pa, ba), (lb, pb, bb) = runs
    assert la == lb and len(la) == 8
    assert all(torch.equal(a, b) for a, b in zip(pa + ba, pb + bb))


# --------------------------------------------------- across the packages

def test_moe_checkpoints_resume_across_packages(tmp_path):
    """Each package trains the MoE model 4 steps (an epoch one batch)
    with a checkpoint every 2 iterations; each resumes from the other's
    ``checkpoint.2`` (after step 1, with the MoE state) to step 4 and
    ends within 1e-5 of the writer's uninterrupted run."""
    _, params = _weights(seed=11)
    rows = _rows()
    runs = {}
    for pkg in ("jax", "port"):
        model = _weights(seed=11)[0] if pkg == "jax" else _port(params)
        opt = _optimizer(pkg, model, rows, 4, ckdir=tmp_path / pkg)
        opt.optimize()
        runs[pkg] = flat(model.get_parameters() if pkg == "jax"
                         else export_params(model))
    cks = {pkg: jser.load_checkpoint(str(tmp_path / pkg / "checkpoint.2"))
           for pkg in runs}
    for ck in cks.values():
        mlp = ck["model_state"]["block_1"]["mlp"]
        assert set(mlp) == {JAX_AUX_KEY, "expert_frac"}
    assert_trees_close(cks["port"]["model_state"],
                       cks["jax"]["model_state"], 1e-6)
    for writer, reader in (("port", "jax"), ("jax", "port")):
        resume = tmp_path / f"{writer}-to-{reader}"
        resume.mkdir()
        shutil.copytree(tmp_path / writer / "checkpoint.2",
                        resume / "checkpoint.2")
        model = _weights(seed=12)[0] if reader == "jax" \
            else _port(_weights(seed=12)[1])
        opt = _optimizer(reader, model, rows, 4, ckdir=resume)
        opt.optimize()
        got = flat(model.get_parameters() if reader == "jax"
                   else export_params(model))
        for key, want in runs[writer].items():
            np.testing.assert_allclose(got[key], want, atol=ATOL, rtol=0,
                                       err_msg=f"{writer} -> {reader} {key}")


def test_module_snapshots_load_in_either_package(tmp_path):
    """A snapshot of an MoE, untied, dropout TransformerLM written by
    ``save_module`` in either package rebuilds in the other (the JAX
    spec's ``ring_axis``, ``sp_impl``, ``mesh``, ``moe_experts``,
    ``moe_every`` and ``tie_embeddings`` arguments included) and gives
    the writer's evaluation logits."""
    kw = dict(tie_embeddings=False, dropout=0.1, ring_axis=None,
              sp_impl="ring", mesh=None, moe_every=2)
    ref, params = _weights(seed=13, **kw)
    x = np.stack([r[0][0] for r in _rows()])
    want = np.asarray(ref.evaluate().forward(jnp.asarray(x)))
    jser.save_module(str(tmp_path / "jax"), ref)
    port = pser.load_module(str(tmp_path / "jax"), device="cpu")
    assert isinstance(port, TransformerLM) and not port.tie_embeddings
    with torch.no_grad():
        got = port.evaluate()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    pser.save_module(str(tmp_path / "port"), port)
    back = jser.load_module(str(tmp_path / "port"))
    np.testing.assert_allclose(
        np.asarray(back.evaluate().forward(jnp.asarray(x))), want,
        atol=ATOL, rtol=0)


def test_sequence_parallel_arguments_raise():
    """The sequence-parallel arguments are ported: at world 1 a
    ``ring_axis`` runs the dense path (``resolve_axis_mesh`` finds no
    axis that splits), and so does a ``mesh`` that is no mesh at all, as
    the JAX package's TransformerLM does with the same argument (it
    stores it and never reads it without a ``ring_axis``); both give
    the plain model's logits. An unknown ``sp_impl`` still raises, and
    MoE blocks on a mesh of more than one rank raise (item 11)."""
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu_torch.parallel import Mesh

    tokens = np.random.RandomState(0).randint(0, GEOM["vocab_size"],
                                              (2, 8))
    plain = TransformerLM(**GEOM, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    want = plain.evaluate()(torch.from_numpy(tokens)).detach().numpy()
    for kw in (dict(ring_axis="seq"), dict(mesh=object())):
        port = TransformerLM(**GEOM, device="cpu", **kw,
                             generator=torch.Generator().manual_seed(0))
        got = port.evaluate()(torch.from_numpy(tokens)).detach().numpy()
        np.testing.assert_array_equal(got, want)
    ref = JaxLM(**GEOM, mesh=object())
    ref.set_parameters(to_jax(export_params(plain)))
    np.testing.assert_allclose(
        np.asarray(ref.evaluate().forward(jnp.asarray(tokens))), want,
        atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="sp_impl"):
        TransformerLM(**GEOM, sp_impl="zigzag", device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        TransformerLM(**{**GEOM, "moe_experts": 2}, device="cpu",
                      mesh=Mesh([2], ["data"]))


# -------------------------------------------------------------- RMSNorm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    """Forward in both dtypes (float32 within 1e-5, bfloat16 within one
    rounding), and in float32 the gradients of ``sum(y * g)``."""
    ref = jnn.RMSNorm(24)
    port = nn.RMSNorm(24)
    w = (1 + 0.1 * _x((24,), seed=4)).astype(np.float32)
    x, g = _x((3, 5, 24)) * 3, _x((3, 5, 24), seed=5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    port.set_parameters({"weight": w})
    port.to(td)

    def f(p, xj):
        return ref.forward_fn(p, xj)
    want, vjp = jax.vjp(f, {"weight": jnp.asarray(w, jd)},
                        jnp.asarray(x, jd))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    got = port(xt)
    assert got.dtype == td
    if dtype == "bfloat16":
        np.testing.assert_allclose(
            got.detach().float().numpy(), np.asarray(want, np.float32),
            rtol=2 ** -8, atol=0)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)
    got.backward(torch.from_numpy(g))
    gw, gx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(port.weight.grad.numpy(),
                               np.asarray(gw["weight"]), atol=GRAD_ATOL,
                               rtol=0)
