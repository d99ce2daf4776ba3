"""The rest of optim, the port against the JAX package: every
learning-rate schedule, the OptimMethods Adam, Adagrad, Adadelta,
Adamax, RMSprop and Ftrl (and SGD beside them) through ``LocalOptimizer``
on both sides, their checkpoints resumed across packages, windows of
steps, the float16 skip-step over Adam's state, the hyper-parameters a
step reads, and the Optimizer's ``set_model`` and
``set_drop_module_property``.

Tolerances:

- schedules: rates, counters and hyper-parameters bitwise (host Python
  on floats and ints in both packages);
- methods: each step's loss within 1e-5 relative of the JAX package's;
  the MLP's parameters within 1e-5 of its (measured: 1.2e-7 at most);
  the TransformerLM's within 1e-5 (measured: 1.2e-6 at most), RMSprop's
  within 5e-5 (measured 1.5e-5 on one element of a query weight: its
  first step divides by ``sqrt(0.01 g^2) + 1e-8``, so where ``|g|`` is
  near ``1e-7`` the update follows the two packages' last-bit gradient
  differences at full scale). The attention's key bias ``bk`` is held
  by the losses only: its gradient is 0 in exact arithmetic (it shifts a
  row of scores by a constant, which the softmax takes out), so each
  package's update of it is its own rounding noise, which Adam, Adamax,
  Adagrad and RMSprop scale up to a full step (measured 3.6e-4 to
  1.4e-2 apart). Where the JAX package's Adamax makes a parameter NaN
  (a gradient that is exactly 0: see
  ``test_adamax_keeps_a_zero_gradient_parameter_where_jax_makes_it_nan``)
  the port's must equal its start;
- checkpoints resumed across packages: parameters within 1e-5 of the
  writer's own uninterrupted run (an epoch is one batch of 8 rows; the
  resumed run's shuffle orders the rows otherwise, so the sums round
  otherwise);
- windows and the skip-step: bitwise, on the CPU.
"""
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
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.trigger import Trigger as JaxTrigger
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.convert import export_params, load_jax_params
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.optim import optim_method as pom
from bigdl_tpu_torch.precision import (MASTER_KEY, SCALER_KEY,
                                       DynamicLossScaler, PrecisionPolicy)
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import flat, to_jax

RTOL = 1e-5
ATOL = 1e-5
RMSPROP_LM_ATOL = 5e-5
RESUME_ATOL = 1e-5

#: every method at a rate its users train with
METHODS = {
    "SGD": dict(learning_rate=0.1, momentum=0.9),
    "Adam": dict(learning_rate=1e-3),
    "Adagrad": dict(learning_rate=1e-2, weight_decay=1e-3),
    "Adadelta": dict(),
    "Adamax": dict(),
    "RMSprop": dict(learning_rate=1e-3),
    "Ftrl": dict(learning_rate=0.1, l1_regularization_strength=1e-3,
                 l2_regularization_strength=1e-3),
}
STATE_KEYS = {"SGD": {"v"}, "Adam": {"m", "v", "t"}, "Adagrad": {"accum"},
              "Adadelta": {"accum_g", "accum_dx"}, "Adamax": {"m", "u", "t"},
              "RMSprop": {"accum"}, "Ftrl": {"accum", "linear"}}
_PKG = {"jax": (jnn, joptim, JaxDataSet, JaxSample, JaxSampleToMiniBatch,
                JaxRandomGenerator, JaxTrigger),
        "port": (nn, optim, DataSet, Sample, SampleToMiniBatch,
                 RandomGenerator, optim.Trigger)}
LM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
          max_len=32)


# ---------------------------------------------------------------- helpers

_CACHE = {}


def _mlp(pkg):
    n = _PKG[pkg][0]
    if pkg == "jax":
        return n.Sequential().add(n.Linear(8, 16)).add(n.Tanh()) \
            .add(n.Linear(16, 3)).add(n.LogSoftMax())
    return n.Sequential(n.Linear(8, 16), n.Tanh(), n.Linear(16, 3),
                        n.LogSoftMax())


def _weights(kind):
    """Seeded JAX weights of the MLP or the 2-layer TransformerLM, made
    once, carried into both packages."""
    if kind not in _CACHE:
        JaxRandomGenerator.set_seed(1)
        ref = _mlp("jax") if kind == "mlp" else JaxTransformerLM(**LM)
        ref.ensure_initialized()
        _CACHE[kind] = jax.tree.map(np.asarray, ref.get_parameters())
    return _CACHE[kind]


def _model(pkg, kind):
    w = _weights(kind)
    if kind == "mlp":
        m = _mlp(pkg)
        return m.set_parameters(to_jax(w) if pkg == "jax" else w)
    if pkg == "jax":
        m = JaxTransformerLM(**LM)
        m.set_parameters(to_jax(w))
        return m
    return load_jax_params(TransformerLM(**LM, device="cpu"), w)


def _samples(kind, n):
    """``n`` rows of the MLP's 3-class task (no row with a zero input),
    or of the train CLI's packed synthetic documents."""
    if kind == "mlp":
        r = np.random.RandomState(0)
        x = r.randn(n, 8).astype(np.float32) + 0.1
        y = (np.arange(n) % 3 + 1).astype(np.float32)
        return [(x[i], y[i]) for i in range(n)]
    if "corpus" not in _CACHE:
        _CACHE["corpus"] = transformer_train.synthetic_corpus(
            3000, LM["vocab_size"], LM["max_len"], "packed", 4)
    cx, cy = _CACHE["corpus"]
    return [([p[i] for p in cx], cy[i]) for i in range(n)]


def _criterion(pkg, kind):
    n = _PKG[pkg][0]
    return n.ClassNLLCriterion() if kind == "mlp" \
        else n.SequenceCrossEntropyCriterion(ignore_index=-1)


def _recorder(trigger_cls, record, steps):
    """An end trigger after ``steps`` iterations recording each step's
    loss by ``neval``."""
    def fn(state):
        record[state["neval"]] = state.get("Loss")
        return state["neval"] > steps
    return trigger_cls(fn)


def _run(pkg, kind, name, steps, *, rows=24, batch=8, seed=4,
         ckdir=None, every=1000):
    """``steps`` LocalOptimizer iterations of ``kind`` with method
    ``name``: ``(optimizer, {neval: loss}, flat params)``."""
    _, o, ds, sample, smb, rg, trig = _PKG[pkg]
    model = _model(pkg, kind)
    rg.set_seed(seed)
    data = ds.array([sample(x, y) for x, y in _samples(kind, rows)]) \
        .transform(smb(batch))
    opt = o.LocalOptimizer(model, data, _criterion(pkg, kind),
                           batch_size=batch)
    opt.set_optim_method(getattr(o, name)(**METHODS[name]))
    if ckdir is not None:
        opt.set_checkpoint(str(ckdir), o.several_iteration(every))
    losses = {}
    opt.set_end_when(_recorder(trig, losses, steps))
    opt.optimize()
    params = model.get_parameters() if pkg == "jax" \
        else export_params(model)
    return opt, losses, flat(params)


def _assert_losses_close(got, want):
    assert sorted(got) == sorted(want)
    for n in want:
        if want[n] is not None:
            np.testing.assert_allclose(got[n], want[n], rtol=RTOL,
                                       err_msg=f"loss at neval {n}")


# -------------------------------------------------------------- schedules

def _schedules(m):
    """Each schedule of the package ``m`` in the configurations its
    users set."""
    return {
        "Default": None,
        "Step": m.Step(7, 0.5),
        "MultiStep": m.MultiStep([5, 12, 30], 0.3),
        "EpochStep": m.EpochStep(1, 0.7),
        "EpochDecay": m.EpochDecay(lambda e: e // 2),
        "EpochSchedule": m.EpochSchedule([
            m.Regime(1, 1, {"learningRate": 0.3}),
            m.Regime(2, 2, {"learningRate": 0.05, "weightDecay": 5e-4}),
            m.Regime(3, 9, {"momentum": 0.5})]),
        "Poly": m.Poly(0.5, 40),
        "NaturalExp": m.NaturalExp(6, 0.25),
        "Exponential": m.Exponential(9, 0.8),
        "Exponential staircase": m.Exponential(9, 0.8, staircase=True),
        "Plateau": m.Plateau(factor=0.5, patience=1, mode="max",
                             epsilon=1e-3, cooldown=1, min_lr=0.01),
        "Warmup": m.Warmup(0.004),
        "SequentialSchedule": m.SequentialSchedule(17)
        .add(m.Warmup(0.002), 10).add(m.Poly(0.5, 30), 30)
        .add(m.Exponential(5, 0.9), 5),
    }


@pytest.mark.parametrize("name", sorted(_schedules(pom)))
def test_schedule_rates_and_counters_are_bitwise_the_jax_packages(name):
    """50 iterations over 3 epochs through ``SGD.update_hyper_parameter``
    (the driver's per-iteration call, with its ``epoch`` and ``neval``
    set as the driver sets them): every rate, the method's host state
    and the hyper-parameters an ``EpochSchedule`` writes are bitwise the
    JAX package's. Plateau records a score at each epoch's end."""
    jax_sched, port_sched = _schedules(jom)[name], _schedules(pom)[name]
    want = jom.SGD(learning_rate=0.1, learning_rate_decay=0.02,
                   learning_rate_schedule=jax_sched)
    got = pom.SGD(learning_rate=0.1, learning_rate_decay=0.02,
                  learning_rate_schedule=port_sched)
    scores = {1: 0.5, 2: 0.5005, 3: 0.7}
    for i in range(50):
        epoch = 1 + i * 3 // 50
        if i and epoch != 1 + (i - 1) * 3 // 50 and name == "Plateau":
            for sched in (jax_sched, port_sched):
                sched.record_metric(scores[epoch - 1])
        for m in (want, got):
            m.state.update(epoch=epoch, neval=i + 1)
        lr_want = want.update_hyper_parameter()
        lr_got = got.update_hyper_parameter()
        assert type(lr_got) is type(lr_want)
        assert float(lr_got).hex() == float(lr_want).hex(), (i, epoch)
        assert got.state == want.state
        assert (got.weight_decay, got.momentum) == \
            (want.weight_decay, want.momentum)
    if name == "Plateau":
        assert vars(port_sched) == vars(jax_sched)
        assert port_sched._lr < 0.1      # the cut happened


# ---------------------------------------------------------------- methods

@pytest.mark.parametrize("kind", ["mlp", "transformer"])
@pytest.mark.parametrize("name", sorted(METHODS))
def test_five_steps_match_jax(name, kind):
    """Five ``LocalOptimizer`` iterations (3 batches an epoch: the
    fourth follows a rollover's reshuffle) from the same seeded weights
    and shuffles in both packages."""
    _, j_losses, j_params = _run("jax", kind, name, 5)
    p_opt, p_losses, p_params = _run("port", kind, name, 5)
    _assert_losses_close(p_losses, j_losses)
    atol = RMSPROP_LM_ATOL if (name, kind) == ("RMSprop", "transformer") \
        else ATOL
    assert sorted(p_params) == sorted(j_params)
    start = flat(_weights(kind))
    for key, want in j_params.items():
        if key.endswith(".bk"):
            continue        # held by the losses (module docstring)
        got = p_params[key]
        if name == "Adamax":
            # the JAX package's NaN where a gradient is exactly 0 (the
            # TransformerLM's unused positions and token ids): the port's
            # parameter stays
            zero = np.isnan(want)
            np.testing.assert_array_equal(got[zero], start[key][zero])
            got, want = got[~zero], want[~zero]
        np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                   err_msg=key)
    opt_state = p_opt.train_step.opt_state
    assert set(opt_state) == STATE_KEYS[name]
    if "t" in opt_state:
        assert opt_state["t"].dtype == torch.int32
        assert int(opt_state["t"]) == 5


def test_update_never_writes_the_gradients():
    """A step reads the gradients and leaves them as they were (the
    driver and the card checks read ``p.grad`` after the update)."""
    params = [torch.ones(3), torch.full((2, 2), 2.0)]
    for name in sorted(METHODS):
        method = getattr(optim, name)(**METHODS[name])
        state = method.init_state(params)
        grads = [torch.tensor([0.5, -1.0, 2.0]),
                 torch.tensor([[1.0, -0.25], [3.0, 0.125]])]
        before = [g.clone() for g in grads]
        method.update(grads, state, [p.clone() for p in params], 0.1)
        assert all(torch.equal(g, b) for g, b in zip(grads, before)), name


def test_ftrl_accumulator_starts_at_its_initial_value_as_in_jax():
    p = [torch.zeros(3)]
    got = optim.Ftrl(initial_accumulator_value=0.25).init_state(p)
    want = joptim.Ftrl(initial_accumulator_value=0.25).init_state(
        [jnp.zeros(3)])
    np.testing.assert_array_equal(got["accum"][0].numpy(),
                                  np.asarray(want["accum"][0]))
    assert float(got["accum"][0][0]) == 0.25


def test_adam_rate_tensor_equals_rate_float_bitwise():
    """The driver stages the rate as a 0-d tensor (a captured window
    reads it from a buffer): Adam's step equals the same step with the
    rate as a Python float, bitwise."""
    g = [torch.linspace(-1, 1, 7), torch.full((2,), 0.3)]
    out = []
    for lr in (1e-3, torch.tensor(1e-3)):
        p = [torch.ones(7), torch.ones(2)]
        method = optim.Adam()
        state = method.init_state(p)
        for _ in range(3):
            method.update(g, state, p, lr)
        out.append(p + state["m"] + state["v"] + [state["t"]])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_adamax_keeps_a_zero_gradient_parameter_where_jax_makes_it_nan():
    """``epsilon=1e-38`` is below float32's smallest normal. The JAX
    package's CPU backend flushes it to 0, so ``u = max(b2 u, |g| +
    eps)`` is 0 where the gradient is exactly 0 and the parameter
    becomes 0 / 0 = NaN. Torch keeps the subnormal: ``u = 1e-38``, ``m /
    u = 0``, and the parameter stays. Both pinned (ROADMAP queue 3,
    "Reference behaviour")."""
    g = np.array([0.0, 1.0, 0.0, -2.0], np.float32)
    jm = joptim.Adamax(learning_rate=0.1)
    jp, _ = jm.update([jnp.asarray(g)], jm.init_state([jnp.ones(4)]),
                      [jnp.ones(4)], 0.1)
    want = np.asarray(jp[0])
    assert np.isnan(want[[0, 2]]).all()
    np.testing.assert_allclose(want[[1, 3]], [0.9, 1.1], rtol=1e-6)
    pm = optim.Adamax(learning_rate=0.1)
    p = [torch.ones(4)]
    state = pm.init_state(p)
    pm.update([torch.from_numpy(g)], state, p, 0.1)
    np.testing.assert_allclose(p[0].numpy(), [1.0, 0.9, 1.0, 1.1],
                               rtol=1e-6)
    assert float(state["u"][0][0]) == np.float32(1e-38) > 0


# ----------------------------------------------------------- checkpoints

@pytest.mark.parametrize("name", sorted(METHODS))
def test_checkpoints_resume_across_packages(name, tmp_path):
    """Each package trains the MLP 4 steps (an epoch one batch of 8
    rows) from the same weights with a checkpoint every 2 iterations.
    Each package's ``checkpoint.2`` (after step 1) holds the method's
    state under the JAX keys (``t`` a 0-d int32 array reading 1). The
    JAX package resumes from the port's ``checkpoint.2`` and the port
    from the JAX package's, each to step 4: both equal the writer's
    uninterrupted run (the resumed Adam applies steps 2-4's bias
    corrections, not steps 1-3's)."""
    runs = {pkg: _run(pkg, "mlp", name, 4, rows=8, batch=8,
                      ckdir=tmp_path / pkg, every=2)
            for pkg in ("jax", "port")}
    cks = {pkg: jser.load_checkpoint(str(tmp_path / pkg / "checkpoint.2"))
           for pkg in runs}
    for ck in cks.values():
        assert set(ck["opt_state"]) == STATE_KEYS[name]
        if "t" in ck["opt_state"]:
            t = np.asarray(ck["opt_state"]["t"])
            assert t.dtype == np.int32 and t.shape == () and int(t) == 1
    for key in STATE_KEYS[name] - {"t"}:
        np.testing.assert_allclose(
            np.concatenate([a.ravel() for _, a in sorted(
                flat(cks["port"]["opt_state"][key]).items())]),
            np.concatenate([a.ravel() for _, a in sorted(
                flat(cks["jax"]["opt_state"][key]).items())]),
            atol=1e-6, err_msg=key)
    assert cks["port"]["optim_host_state"] == cks["jax"]["optim_host_state"]
    for writer, reader in (("port", "jax"), ("jax", "port")):
        resume = tmp_path / f"{writer}-to-{reader}"
        resume.mkdir()
        shutil.copytree(tmp_path / writer / "checkpoint.2",
                        resume / "checkpoint.2")
        opt, losses, params = _run(reader, "mlp", name, 4, rows=8, batch=8,
                                   seed=9, ckdir=resume)
        assert sorted(losses) == [2, 3, 4, 5]
        _, want_losses, want = runs[writer]
        for n in (3, 4, 5):
            np.testing.assert_allclose(losses[n], want_losses[n], rtol=RTOL)
        for key in want:
            np.testing.assert_allclose(params[key], want[key],
                                       atol=RESUME_ATOL, rtol=0,
                                       err_msg=f"{writer} -> {reader} {key}")
        if reader == "port" and "t" in STATE_KEYS[name]:
            assert int(opt.train_step.opt_state["t"]) == 4


def test_state_tree_carries_adams_step_count_both_ways():
    """``state_tree`` turns ``t`` into a 0-d numpy array and
    ``load_state_tree`` copies it back into the live tensor (with the
    list buffers), so a resumed Adam goes on counting."""
    params = [torch.ones(2, 3), torch.ones(3)]
    method = optim.Adam()
    state = method.init_state(params)
    for _ in range(3):
        method.update([torch.full((2, 3), 0.5), torch.full((3,), -0.5)],
                      state, params, 0.01)
    tree = method.state_tree(state, lambda ts: {"w": ts[0].numpy().copy(),
                                                "b": ts[1].numpy().copy()})
    assert isinstance(tree["t"], np.ndarray) and int(tree["t"]) == 3
    fresh = method.init_state(params)
    live_t = fresh["t"]
    method.load_state_tree(fresh, tree, lambda t: [t["w"], t["b"]])
    assert fresh["t"] is live_t and int(live_t) == 3
    for key in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(fresh[key],
                                                     state[key]))


# --------------------------------------------------- windows, skip-step

def _windowed(k, method):
    RandomGenerator.set_seed(11)
    data = DataSet.array([Sample(x, y) for x, y in _samples("mlp", 24)]) \
        .transform(SampleToMiniBatch(8))
    opt = optim.LocalOptimizer(_model("port", "mlp"), data,
                               nn.ClassNLLCriterion(), batch_size=8)
    opt.set_optim_method(method())
    opt.set_end_when(optim.max_iteration(12))
    opt.set_steps_per_sync(k)
    model = opt.optimize()
    return opt, [t.detach().clone() for t in model.parameters()]


@pytest.mark.parametrize("method", [
    lambda: optim.Adam(learning_rate=1e-2),
    lambda: optim.SGD(learning_rate=0.1, learning_rate_schedule=optim
                      .SequentialSchedule().add(optim.Warmup(0.01), 6)
                      .add(optim.Poly(0.5, 12), 12))],
    ids=["Adam", "SGD Warmup then Poly"])
def test_windows_of_four_are_the_per_step_loop_bitwise(method):
    """12 steps at K = 4 and K = 1 (3 batches an epoch, so windows end
    at rollovers): losses, rates, parameters and every OptimMethod
    buffer bitwise (Adam's ``t`` reads 12); a warm-up rate schedule
    crosses window boundaries."""
    one, p1 = _windowed(1, method)
    four, p4 = _windowed(4, method)
    assert [h["loss"] for h in one.history] == \
        [h["loss"] for h in four.history]
    assert [h["lr"] for h in one.history] == [h["lr"] for h in four.history]
    assert all(torch.equal(a, b) for a, b in zip(p1, p4))
    s1, s4 = one.train_step.opt_state, four.train_step.opt_state
    assert s1.keys() == s4.keys()
    for key in s1:
        a, b = s1[key], s4[key]
        pairs = zip(a, b) if isinstance(a, list) else [(a, b)]
        assert all(torch.equal(x, y) for x, y in pairs), key
    if "t" in s1:
        assert int(s4["t"]) == 12
    assert four.window is not None and len(four.window.shapes) >= 1


def test_a_skipped_float16_step_leaves_adams_state_bitwise():
    """f16_mixed from a loss scale of 2**40: the first step's float16
    gradients overflow, the step is skipped and the parameters, the
    master, ``m``, ``v`` and ``t`` stay bitwise as they were; the scale
    halves until a step applies, which advances ``t`` by one."""
    model = _model("port", "mlp")
    step = optim.build_train_step(
        model, nn.ClassNLLCriterion(), optim.Adam(learning_rate=1e-2),
        precision=PrecisionPolicy.f16_mixed(),
        loss_scaler=DynamicLossScaler(init_scale=2.0 ** 40))
    optim.seed_precision(step)
    st = step.opt_state
    state = [*model.parameters(), *st[MASTER_KEY], *st["m"], *st["v"],
             st["t"]]
    assert {t.dtype for t in [*st["m"], *st["v"], *st[MASTER_KEY]]} == \
        {torch.float32}
    x, y = zip(*_samples("mlp", 8))
    inp, tgt = torch.from_numpy(np.stack(x)), torch.from_numpy(np.stack(y))
    applied = 0
    for _ in range(40):
        before = [t.detach().clone() for t in state]
        skipped = int(st[SCALER_KEY]["skipped"])
        step(inp, tgt, torch.tensor(1e-2))
        if int(st[SCALER_KEY]["skipped"]) > skipped:
            assert all(torch.equal(a, b) for a, b in zip(state, before))
        else:
            applied += 1
            assert int(st["t"]) == applied
            break
    assert int(st[SCALER_KEY]["skipped"]) >= 1 and applied == 1


def test_buffers_under_a_master_are_float32_whatever_the_parameters():
    """Parameters already stored in float16 (a model cast down before the
    step is built): under f16_mixed the update runs on the float32
    master, so Adam's ``m`` and ``v`` are float32, as the JAX package's
    become after its first step."""
    model = _model("port", "mlp")
    for p in model.parameters():
        p.data = p.data.half()
    step = optim.build_train_step(model, nn.ClassNLLCriterion(),
                                  optim.Adam(),
                                  precision=PrecisionPolicy.f16_mixed())
    assert {t.dtype for t in step.opt_state["m"] + step.opt_state["v"]} \
        == {torch.float32}


# --------------------------------------------- hyper-parameters of a step

def _linear_run(pkg, regime_from, k=1):
    """Linear 4 -> 2 and LogSoftMax, 8 rows in batches of 4, 6 steps
    (3 epochs), SGD at 0.1 whose EpochSchedule adds ``weightDecay 0.5``
    from epoch ``regime_from`` (None: plain SGD)."""
    n, o, ds, sample, smb, rg, _ = _PKG[pkg]
    m = jom if pkg == "jax" else pom
    JaxRandomGenerator.set_seed(2)
    ref = jnn.Sequential().add(jnn.Linear(4, 2)).add(jnn.LogSoftMax())
    ref.ensure_initialized()
    w = jax.tree.map(np.asarray, ref.get_parameters())
    model = ref if pkg == "jax" else \
        nn.Sequential(nn.Linear(4, 2), nn.LogSoftMax()).set_parameters(w)
    r = np.random.RandomState(3)
    x = r.randn(8, 4).astype(np.float32)
    y = (np.arange(8) % 2 + 1).astype(np.float32)
    rg.set_seed(5)
    opt = o.LocalOptimizer(model, ds.array([sample(x[i], y[i])
                                            for i in range(8)])
                           .transform(smb(4)), n.ClassNLLCriterion(),
                           batch_size=4)
    regimes = [m.Regime(1, 9, {"learningRate": 0.1})]
    if regime_from is not None:
        regimes.append(m.Regime(regime_from, 9, {"weightDecay": 0.5}))
    opt.set_optim_method(o.SGD(learning_rate=0.1,
                               learning_rate_schedule=m.EpochSchedule(
                                   regimes)))
    opt.set_end_when(o.max_iteration(6))
    if pkg == "port":
        opt.set_steps_per_sync(k)
    opt.optimize()
    return flat(model.get_parameters())


def _bitwise_trees(a, b):
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def test_a_later_epochs_weight_decay_reaches_neither_packages_step():
    """An EpochSchedule regime that adds ``weightDecay 0.5`` from epoch 2
    leaves the final parameters bitwise those of plain SGD in the JAX
    package (its step was traced at the first call) and in the port (its
    step reads the method as its first call found it), per step and
    windowed; the same regime from epoch 1 changes them in both (ROADMAP
    queue 3, "Reference behaviour")."""
    plain = {pkg: _linear_run(pkg, None) for pkg in ("jax", "port")}
    later = {pkg: _linear_run(pkg, 2) for pkg in ("jax", "port")}
    first = {pkg: _linear_run(pkg, 1) for pkg in ("jax", "port")}
    assert _bitwise_trees(later["jax"], plain["jax"])
    assert _bitwise_trees(later["port"], plain["port"])
    assert _bitwise_trees(_linear_run("port", 2, k=8), plain["port"])
    assert not _bitwise_trees(first["jax"], plain["jax"])
    assert not _bitwise_trees(first["port"], plain["port"])
    assert _bitwise_trees(_linear_run("port", 1, k=8), first["port"])
    for runs in (plain, first):
        for key in runs["jax"]:
            np.testing.assert_allclose(runs["port"][key], runs["jax"][key],
                                       atol=1e-6, err_msg=key)


# ------------------------------------------------------ Optimizer surface

def test_set_model_drops_the_old_models_step_and_window():
    """After a windowed run, ``set_model`` swaps the model and drops the
    step and the window built for the old one; the next run trains the
    new model and leaves the old one as it was."""
    opt, _ = _windowed(4, lambda: optim.Adam(learning_rate=1e-2))
    old = opt.model
    kept = [p.detach().clone() for p in old.parameters()]
    new = _model("port", "mlp")
    start = [p.detach().clone() for p in new.parameters()]
    assert opt.set_model(new) is opt
    assert opt.model is new and opt.train_step is None \
        and opt.window is None
    opt.set_end_when(optim.max_iteration(16))
    opt.optimize()
    assert all(torch.equal(a, b) for a, b in zip(old.parameters(), kept))
    assert not all(torch.equal(a, b)
                   for a, b in zip(new.parameters(), start))
    assert opt.train_step.module is new


def test_set_drop_module_property_is_accepted_and_does_nothing():
    """Straggler dropping is a no-op in both packages, kept for the
    recipes: the runs with and without it are bitwise equal."""
    runs = []
    for drop in (False, True):
        RandomGenerator.set_seed(11)
        data = DataSet.array([Sample(x, y) for x, y in _samples("mlp", 24)]
                             ).transform(SampleToMiniBatch(8))
        opt = optim.LocalOptimizer(_model("port", "mlp"), data,
                                   nn.ClassNLLCriterion(), batch_size=8)
        if drop:
            assert opt.set_drop_module_property(0.04, 0.1, 64, 20) is opt
        opt.set_end_when(optim.max_iteration(4))
        runs.append([p.detach().clone() for p in opt.optimize()
                     .parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    j_opt = joptim.LocalOptimizer(
        _model("jax", "mlp"), JaxDataSet.array([JaxSample(x, y) for x, y
                                                in _samples("mlp", 8)]),
        jnn.ClassNLLCriterion())
    assert j_opt.set_drop_module_property(0.04, 0.1, 64, 20) is j_opt


def test_the_port_exports_what_the_jax_package_does():
    names = ["Adam", "Adagrad", "Adadelta", "Adamax", "RMSprop", "Ftrl",
             "Step", "MultiStep", "EpochStep", "Regime", "EpochSchedule",
             "Poly", "NaturalExp", "Exponential", "Plateau", "Warmup",
             "SequentialSchedule", "LBFGS"]
    for name in names:
        assert name in optim.__all__ and hasattr(joptim, name), name
        assert isinstance(getattr(optim, name), type)
