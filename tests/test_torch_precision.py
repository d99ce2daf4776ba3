"""The port's precision policy, loss scaler and policy train step against
the JAX package's (``bigdl_tpu.precision``, ``build_train_step``'s
precision path) on the same seeded inputs and weights.

Tolerances (each measured on the CPU and stated with its test):

- the policy objects, the scaler's state machine, the float16 skip-step
  and the master cast-down: bitwise;
- float32 steps: 1e-6 absolute on losses and parameters (the two
  packages reduce in other orders);
- bfloat16 steps: 2e-3 on the losses and 2e-3 on the parameters of 12
  MLP steps (measured 7.3e-4 and 1.9e-4; XLA keeps excess precision
  inside its fused bfloat16 expressions where torch rounds after every
  op), within the 2e-2 the JAX package allows bf16 against f32;
- TransformerLM and ResNet-20 under bf16_mixed: the losses, parameters
  and BN statistics within the limits each test states beside what it
  measured.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu.precision as jprec
from bigdl_tpu.dataset import DataSet as JaxDataSet
from bigdl_tpu.dataset import Sample as JaxSample
from bigdl_tpu.dataset import SampleToMiniBatch as JaxSampleToMiniBatch
from bigdl_tpu.optim.optimizer import build_eval_step as jax_eval_step
from bigdl_tpu.optim.optimizer import build_train_step as jax_train_step
from bigdl_tpu.utils.engine import Engine as JaxEngine
from bigdl_tpu.utils.random import RandomGenerator as JaxRandomGenerator
from bigdl_tpu_torch import nn, optim, telemetry
from bigdl_tpu_torch import precision as prec
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.optim import build_eval_step, build_train_step
from bigdl_tpu_torch.utils import engine
from bigdl_tpu_torch.utils.random import RandomGenerator

from _torch_parity import assert_trees_close, flat

PRESETS = ("f32", "bf16_mixed", "f16_mixed")
BF16_LOSS_ATOL, BF16_PARAM_ATOL = 2e-3, 2e-3


# ------------------------------------------------------------- helpers

def _mlp_pair(seed=3):
    """The JAX test's ``_mlp`` (8 -> 16 -> tanh -> 2, LogSoftMax) in both
    packages with the JAX package's seeded weights."""
    JaxRandomGenerator.set_seed(seed)
    ref = jnn.Sequential().add(jnn.Linear(8, 16)).add(jnn.Tanh()) \
        .add(jnn.Linear(16, 2)).add(jnn.LogSoftMax())
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 2),
                         nn.LogSoftMax()).set_parameters(
        jax.tree.map(lambda a: a.astype(np.float32), params))
    return ref, port, params


def _batch(n=16, d=8, classes=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (rng.randint(0, classes, n) + 1).astype(np.float32)
    return x, y


def _jax_setup(ref, params, policy, scaler):
    optim_ = joptim.SGD(learning_rate=0.1, momentum=0.9)
    p = jax.tree.map(jnp.asarray, params)
    opt = optim_.init_state(p)
    if policy.needs_master:
        opt[jprec.MASTER_KEY] = p
        p = policy.cast_to_param(p)
    if scaler is not None:
        opt[jprec.SCALER_KEY] = scaler.init_state()
    step = jax_train_step(ref.training(), jnn.ClassNLLCriterion(), optim_,
                          precision=policy, loss_scaler=scaler)
    return step, p, opt


def _port_setup(port, policy, scaler):
    """build_train_step with the state seeded as the JAX test seeds it
    (and as ``Optimizer.set_precision`` does)."""
    step = build_train_step(port, nn.ClassNLLCriterion(),
                            optim.SGD(learning_rate=0.1, momentum=0.9),
                            precision=policy, loss_scaler=scaler)
    if policy.needs_master:
        step.opt_state[prec.MASTER_KEY] = [p.detach().clone()
                                           for p in port.parameters()]
        for p in port.parameters():
            p.data = p.data.to(policy.param_dtype)
    if scaler is not None:
        step.opt_state[prec.SCALER_KEY] = scaler.init_state()
    return step


def _scalers(sc):
    return (jprec.DynamicLossScaler(**sc), prec.DynamicLossScaler(**sc)) \
        if sc else (None, None)


def _run_pair(name, steps=12, sc=None):
    """``steps`` steps of the JAX test's MLP step under preset ``name`` in
    both packages: (JAX losses, params, opt_state), (port losses, step)."""
    ref, port, params = _mlp_pair()
    j_sc, p_sc = _scalers(sc)
    j_step, jp, jo = _jax_setup(ref, params,
                                jprec.PrecisionPolicy.named(name), j_sc)
    p_step = _port_setup(port, prec.PrecisionPolicy.named(name), p_sc)
    x, y = _batch()
    jl, pl = [], []
    for i in range(steps):
        jp, jo, _, loss = j_step(jp, jo, ref.get_state(),
                                 jax.random.PRNGKey(i), 0.1, x, y)
        jl.append(float(loss))
        pl.append(float(p_step(torch.from_numpy(x), torch.from_numpy(y),
                               0.1)))
    return (jl, jp, jo), (pl, port, p_step)


# ------------------------------------------------------ policy object

@pytest.mark.parametrize("name", PRESETS)
def test_presets_named_and_describe_match_jax(name):
    got, want = prec.PrecisionPolicy.named(name), \
        jprec.PrecisionPolicy.named(name)
    for f in ("param_dtype", "compute_dtype", "output_dtype",
              "accum_dtype"):
        assert prec.policy.dtype_name(getattr(got, f)) == \
            getattr(want, f).name
    assert (got.is_noop, got.needs_master, got.needs_loss_scaling,
            got.name) == (want.is_noop, want.needs_master,
                          want.needs_loss_scaling, want.name)
    assert got.describe() == want.describe()
    assert got == getattr(prec.PrecisionPolicy, name)()


def test_policy_errors_and_explicit_flags_match_jax():
    for mod in (prec, jprec):
        with pytest.raises(ValueError, match="unknown precision preset"):
            mod.PrecisionPolicy.named("int4_wishful")
        with pytest.raises(ValueError, match="accum_dtype must stay"):
            mod.PrecisionPolicy(accum_dtype="bfloat16")
        assert mod.PrecisionPolicy(compute_dtype="bfloat16",
                                   loss_scaling=True).needs_loss_scaling
        assert not mod.PrecisionPolicy(
            param_dtype="float16", compute_dtype="float16",
            loss_scaling=False).needs_loss_scaling
        assert mod.PrecisionPolicy(compute_dtype="float16").name == "custom"


@pytest.mark.parametrize("default,compute", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
def test_from_engine_matches_jax(default, compute):
    old_j = (JaxEngine.default_dtype(), JaxEngine.compute_dtype())
    old_p = (engine.default_dtype(), engine.compute_dtype())
    try:
        JaxEngine.set_default_dtype(jnp.dtype(default))
        JaxEngine.set_compute_dtype(jnp.dtype(compute))
        engine.set_default_dtype(default)
        engine.set_compute_dtype(compute)
        got, want = prec.PrecisionPolicy.from_engine(), \
            jprec.PrecisionPolicy.from_engine()
        assert got.describe() == want.describe()
        assert (got.is_noop, got.needs_master, got.needs_loss_scaling) == \
            (want.is_noop, want.needs_master, want.needs_loss_scaling)
    finally:
        JaxEngine.set_default_dtype(old_j[0])
        JaxEngine.set_compute_dtype(old_j[1])
        engine.set_default_dtype(old_p[0])
        engine.set_compute_dtype(old_p[1])


def test_cast_floating_and_matmul_accum_dtype():
    tree = {"w": torch.ones(2), "ids": torch.ones(2, dtype=torch.int32),
            "flag": torch.ones(2, dtype=torch.bool),
            "planes": [torch.ones(2), (torch.ones(2, dtype=torch.int64),)]}
    out = prec.cast_floating(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32
    assert out["flag"].dtype == torch.bool
    assert out["planes"][0].dtype == torch.bfloat16
    assert out["planes"][1][0].dtype == torch.int64
    assert out["ids"] is tree["ids"]
    for name in ("bfloat16", "float16", "float32", "float64"):
        assert prec.policy.dtype_name(prec.matmul_accum_dtype(name)) == \
            jnp.dtype(jprec.matmul_accum_dtype(jnp.dtype(name))).name


def test_apply_module_casts_entry_and_exit_without_changing_the_module():
    """bf16_mixed's forward: the output is float32 (the output dtype),
    within 1e-2 of the JAX package's bf16 forward (one bfloat16 rounding
    of values of order 1); the module keeps its float32 parameters and
    its BN buffers stay float32 and unchanged in evaluation mode; the
    gradient reaches the float32 parameters."""
    RandomGenerator.set_seed(1)
    port = nn.Sequential(nn.Linear(4, 3), nn.BatchNormalization(3))
    port.evaluate()
    JaxRandomGenerator.set_seed(1)
    ref = jnn.Sequential().add(jnn.Linear(4, 3)) \
        .add(jnn.BatchNormalization(3))
    ref.ensure_initialized()
    port.set_parameters(jax.tree.map(np.asarray, ref.get_parameters()))
    x = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    out = prec.PrecisionPolicy.bf16_mixed().apply_module(
        port, torch.from_numpy(x))
    want, _ = jprec.PrecisionPolicy.bf16_mixed().apply_module(
        ref, ref.get_parameters(), ref.get_state(), jnp.asarray(x))
    assert out.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-2)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype == torch.float32 for b in port.buffers())
    out.sum().backward()
    w = port[0].weight
    assert w.grad is not None and w.grad.dtype == torch.float32


# ------------------------------------------------- loss-scaler machine

@pytest.mark.parametrize("cfg", [
    dict(init_scale=1024.0, growth_interval=2),
    dict(init_scale=2.0, growth_interval=1, min_scale=1.0, max_scale=4.0),
    dict(init_scale=3.0, growth_factor=3.0, backoff_factor=0.25,
         growth_interval=3, min_scale=0.5, max_scale=200.0)])
def test_scaler_state_machine_matches_jax_bitwise(cfg):
    """40 transitions over a seeded sequence of finite and non-finite
    flags: scale, good_steps and skipped equal JAX's ``next_state``
    bitwise at every step, with the dtypes float32 / int32 / int32."""
    got_sc, want_sc = prec.DynamicLossScaler(**cfg), \
        jprec.DynamicLossScaler(**cfg)
    got, want = got_sc.init_state(), want_sc.init_state()
    flags = np.random.RandomState(11).rand(40) > 0.3
    for f in flags:
        got = got_sc.next_state(got, torch.tensor(bool(f)))
        want = want_sc.next_state(want, jnp.bool_(f))
        for k in ("scale", "good_steps", "skipped"):
            a, b = got[k].numpy(), np.asarray(want[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    state = got_sc.init_state()
    got_sc.advance(state, torch.tensor(False))
    assert float(state["scale"]) == cfg["init_scale"] * got_sc.backoff_factor \
        or float(state["scale"]) == got_sc.min_scale


def test_scaler_scaling_and_probe_match_jax():
    sc, jsc = prec.DynamicLossScaler(init_scale=512.0), \
        jprec.DynamicLossScaler(init_scale=512.0)
    s, js = sc.init_state(), jsc.init_state()
    assert float(sc.scale_loss(torch.tensor(3.0), s)) == \
        float(jsc.scale_loss(jnp.float32(3.0), js)) == 1536.0
    g = np.random.RandomState(0).randn(7).astype(np.float32) * 512
    got = sc.unscale([torch.from_numpy(g)], s)[0].numpy()
    want = np.asarray(jsc.unscale({"w": jnp.asarray(g)}, js)["w"])
    assert got.tobytes() == want.tobytes()
    for leaves in ([np.ones(3), np.zeros(2, np.int32)],
                   [np.array([1.0, np.inf]), np.ones(2)],
                   [np.array([np.nan])], [np.ones(2, np.int32)]):
        assert bool(sc.all_finite([torch.from_numpy(a) for a in leaves])) \
            == bool(jsc.all_finite({str(i): jnp.asarray(a)
                                    for i, a in enumerate(leaves)}))
    for kw in (dict(growth_factor=1.0), dict(backoff_factor=1.5),
               dict(growth_interval=0)):
        with pytest.raises(ValueError):
            prec.DynamicLossScaler(**kw)


# -------------------------------------------------------- the step

@pytest.mark.parametrize("name,atol", [("f32", 1e-6),
                                       ("bf16_mixed", BF16_PARAM_ATOL)])
def test_mlp_steps_match_jax(name, atol):
    """The JAX test's 12 seeded MLP steps (SGD lr 0.1, momentum 0.9).
    float32 within 1e-6 (measured 6e-8 / 3e-8); bf16_mixed within 2e-3
    (losses and parameters; measured 7.3e-4 / 1.9e-4). Parameters stay
    float32 at rest under bf16_mixed, as in the JAX package."""
    (jl, jp, _), (pl, port, _) = _run_pair(name)
    np.testing.assert_allclose(pl, jl, atol=BF16_LOSS_ATOL
                               if name != "f32" else 1e-6)
    assert_trees_close(port.get_parameters(), jax.tree.map(np.asarray, jp),
                       atol=atol)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    if name == "bf16_mixed":
        (fl, _, _), _ = _run_pair("f32")
        assert abs(fl[-1] - pl[-1]) < 2e-2
        assert np.mean([abs(a - b) for a, b in zip(fl, pl)]) < 2e-2


def test_f16_skip_step_and_master_cast_down_match_jax():
    """f16_mixed with ``DynamicLossScaler(init_scale=2**24,
    growth_interval=3)``: the first step overflows in both packages and
    is skipped — parameters, master and momentum bitwise as they were,
    the scale halved, the counter reset, skipped 1; the scaler states of
    the two packages agree bitwise over 8 steps; the at-rest float16
    parameters equal the master cast down, bitwise, after every step;
    the masters agree within 1e-4 (float16 compute; measured 2.9e-6)."""
    sc = dict(init_scale=2.0 ** 24, growth_interval=3)
    ref, port, params = _mlp_pair()
    j_sc, p_sc = _scalers(sc)
    policy = prec.PrecisionPolicy.f16_mixed()
    j_step, jp, jo = _jax_setup(ref, params, jprec.PrecisionPolicy.f16_mixed(),
                                j_sc)
    step = _port_setup(port, policy, p_sc)
    x, y = map(torch.from_numpy, _batch())
    ms = ref.get_state()
    for i in range(8):
        before = [t.clone() for t in [*port.parameters(),
                                      *step.opt_state[prec.MASTER_KEY],
                                      *step.opt_state["v"]]]
        step(x, y, 0.1)
        jp, jo, ms, _ = j_step(jp, jo, ms, jax.random.PRNGKey(i), 0.1,
                               x.numpy(), y.numpy())
        ss, jss = step.opt_state[prec.SCALER_KEY], jo[jprec.SCALER_KEY]
        for k in ("scale", "good_steps", "skipped"):
            assert ss[k].numpy().tobytes() == np.asarray(jss[k]).tobytes()
        if i == 0:
            assert float(ss["scale"]) == 2.0 ** 23
            assert int(ss["good_steps"]) == 0 and int(ss["skipped"]) == 1
            after = [*port.parameters(), *step.opt_state[prec.MASTER_KEY],
                     *step.opt_state["v"]]
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        for p, m in zip(port.parameters(), step.opt_state[prec.MASTER_KEY]):
            assert p.dtype == torch.float16 and m.dtype == torch.float32
            assert torch.equal(p, m.to(torch.float16))
    assert int(step.opt_state[prec.SCALER_KEY]["skipped"]) < 8
    names = [n for n, _ in port.named_parameters()]
    got = dict(zip(names, (m.numpy() for m in
                           step.opt_state[prec.MASTER_KEY])))
    want = flat(jax.tree.map(np.asarray, jo[jprec.MASTER_KEY]))
    for n in names:
        np.testing.assert_allclose(got[n], want[n], atol=1e-4, err_msg=n)


@pytest.mark.parametrize("missing", ["scaler", "master"])
def test_missing_state_raises_as_jax(missing):
    """A step whose policy needs state nobody seeded raises the JAX
    package's error, in both packages."""
    kw = dict(param_dtype="float16", compute_dtype="float16",
              loss_scaling=missing == "scaler")
    match = "scaler state" if missing == "scaler" else "f32 master copy"
    ref, port, params = _mlp_pair()
    x, y = _batch()
    step = build_train_step(port, nn.ClassNLLCriterion(),
                            optim.SGD(learning_rate=0.1),
                            precision=prec.PrecisionPolicy(**kw))
    with pytest.raises(ValueError, match=match):
        step(torch.from_numpy(x), torch.from_numpy(y), 0.1)
    j_sgd = joptim.SGD(learning_rate=0.1)
    j_step = jax_train_step(ref.training(), jnn.ClassNLLCriterion(), j_sgd,
                            precision=jprec.PrecisionPolicy(**kw))
    jp = ref.get_parameters()
    with pytest.raises(ValueError, match=match):
        j_step(jp, j_sgd.init_state(jp), ref.get_state(),
               jax.random.PRNGKey(0), 0.1, x, y)


def test_legacy_engine_low_precision_path_needs_no_master_or_scaler():
    """The Engine dtype knobs at bfloat16 with no policy: a model built
    then has bfloat16 parameters, the step trains them directly (no
    master, no scaler), as the JAX package's legacy path does; the
    first loss within 2e-2 of JAX's (bfloat16 loss)."""
    old = (engine.default_dtype(), engine.compute_dtype())
    old_j = (JaxEngine.default_dtype(), JaxEngine.compute_dtype())
    try:
        engine.set_default_dtype(torch.bfloat16)
        engine.set_compute_dtype(torch.bfloat16)
        JaxEngine.set_default_dtype(jnp.bfloat16)
        JaxEngine.set_compute_dtype(jnp.bfloat16)
        legacy = prec.PrecisionPolicy.from_engine()
        assert not legacy.needs_master and not legacy.needs_loss_scaling
        ref, port, params = _mlp_pair()
        assert all(p.dtype == torch.bfloat16 for p in port.parameters())
        step = build_train_step(port, nn.ClassNLLCriterion(),
                                optim.SGD(learning_rate=0.1, momentum=0.9))
        x, y = _batch()
        loss = float(step(torch.from_numpy(x), torch.from_numpy(y), 0.1))
        assert np.isfinite(loss)
        assert all(p.dtype == torch.bfloat16 for p in port.parameters())
        assert prec.MASTER_KEY not in step.opt_state
        assert prec.SCALER_KEY not in step.opt_state
        j_optim = joptim.SGD(learning_rate=0.1, momentum=0.9)
        j_step = jax_train_step(ref.training(), jnn.ClassNLLCriterion(),
                                j_optim)
        jp = ref.get_parameters()
        *_, jl = j_step(jp, j_optim.init_state(jp), ref.get_state(),
                        jax.random.PRNGKey(0), 0.1, x, y)
        assert abs(loss - float(jl)) < 2e-2
    finally:
        engine.set_default_dtype(old[0])
        engine.set_compute_dtype(old[1])
        JaxEngine.set_default_dtype(old_j[0])
        JaxEngine.set_compute_dtype(old_j[1])


def test_eval_step_under_policy_matches_jax():
    """bf16_mixed evaluation: float32 output (the output dtype) within
    1e-2 of the JAX package's bf16 eval step; without a policy the
    float32 forward within 1e-6."""
    ref, port, params = _mlp_pair()
    x, _ = _batch()
    for policy, atol in ((None, 1e-6), ("bf16_mixed", 1e-2)):
        p_pol = policy and prec.PrecisionPolicy.named(policy)
        j_pol = policy and jprec.PrecisionPolicy.named(policy)
        got = build_eval_step(port, p_pol)(torch.from_numpy(x))
        want = jax_eval_step(ref.evaluate(), precision=j_pol)(
            ref.get_parameters(), ref.get_state(), jnp.asarray(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=atol)
    assert not port.is_training()


@pytest.mark.parametrize("name", PRESETS)
def test_rate_as_a_tensor_is_the_rate_as_a_float_bitwise(name):
    """The driver stages the rate as a 0-d tensor in default_dtype()
    (what a captured window reads); 4 steps with it equal 4 steps with
    the Python float, bitwise, under each preset."""
    sc = dict(init_scale=256.0, growth_interval=4)
    runs = []
    for lr in (0.1, torch.tensor(0.1, dtype=engine.default_dtype())):
        _, port, _ = _mlp_pair()
        p_sc = _scalers(sc)[1] if name == "f16_mixed" else None
        step = _port_setup(port, prec.PrecisionPolicy.named(name), p_sc)
        x, y = map(torch.from_numpy, _batch())
        losses = [float(step(x, y, lr)) for _ in range(4)]
        runs.append((losses, [p.clone() for p in port.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# -------------------------------------------------- Optimizer surface

def _toy_rows(n=128, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d).astype(np.float32) * 3
    x = np.stack([centers[i % classes]
                  + rng.randn(d).astype(np.float32) * 0.5
                  for i in range(n)])
    y = np.array([i % classes + 1 for i in range(n)], np.float32)
    return x, y


def test_set_precision_validates_inputs():
    x, y = _toy_rows(32)
    opt = optim.LocalOptimizer(
        nn.Sequential(nn.Linear(16, 4)),
        DataSet.array([Sample(x[i], y[i]) for i in range(32)])
        .transform(SampleToMiniBatch(8)), nn.ClassNLLCriterion())
    with pytest.raises(ValueError, match="unknown precision preset"):
        opt.set_precision("fp4")
    with pytest.raises(TypeError, match="PrecisionPolicy"):
        opt.set_precision(16)
    with pytest.raises(TypeError, match="DynamicLossScaler"):
        opt.set_precision("f16_mixed", scaler="big")
    assert opt.set_precision("bf16_mixed") is opt
    assert opt.set_precision(None) is opt


def test_f16_optimizer_gauges_and_float32_result():
    """An f16_mixed run through the Optimizer: the policy gauge carries
    the JAX package's labels, the scale and skip gauges are read, and the
    model ends holding the float32 master (params float32 again)."""
    x, y = _toy_rows(64)
    RandomGenerator.set_seed(7)
    g = torch.Generator().manual_seed(7)
    opt = optim.LocalOptimizer(
        nn.Sequential(nn.Linear(16, 32, generator=g), nn.Tanh(),
                      nn.Linear(32, 4, generator=g), nn.LogSoftMax()),
        DataSet.array([Sample(x[i], y[i]) for i in range(64)])
        .transform(SampleToMiniBatch(16)), nn.ClassNLLCriterion(),
        batch_size=16)
    opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(optim.max_iteration(4))
    opt.set_precision("f16_mixed", prec.DynamicLossScaler(init_scale=256.0,
                                                          growth_interval=2))
    model = opt.optimize()
    assert telemetry.gauge("train/precision/policy_info").value(
        policy="f16_mixed", param="float16", compute="float16",
        accum="float32") == 1.0
    # 4 finite steps from 256 at growth_interval 2: doubled twice
    assert telemetry.gauge("train/precision/loss_scale").value() == 1024.0
    assert telemetry.gauge("train/precision/skipped_steps").value() == 0.0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(h["loss"]) for h in opt.history)


def _transformer_pair(layers=2, hidden=64):
    from bigdl_tpu.models.transformer import TransformerLM as JaxLM
    from bigdl_tpu_torch.models import TransformerLM
    geom = dict(vocab_size=64, hidden_size=hidden, num_layers=layers,
                num_heads=4, max_len=32)
    JaxRandomGenerator.set_seed(5)
    ref = JaxLM(**geom)
    ref.ensure_initialized()
    params = jax.tree.map(np.asarray, ref.get_parameters())
    port = TransformerLM(**geom, device="cpu").set_parameters(params)
    return ref, port


def _lm_rows(n=24, seq=32, vocab=64, seed=9):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, vocab, (n, seq + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def test_transformer_bf16_optimizer_steps_match_jax():
    """TransformerLM (2 layers, hidden 64, 4 heads, seq 32), 3
    ``LocalOptimizer`` steps of 8 rows under ``set_precision(
    "bf16_mixed")`` in both packages (the port's attention through K1's
    plain version in bfloat16, the JAX package's einsum path): losses
    within 5e-3 relative (measured 1.7e-4) and parameters within 2e-3
    (measured 6.7e-4), float32 at rest."""
    ref, port = _transformer_pair()
    x, y = _lm_rows()
    runs = {}
    for pkg, (mod_ds, S, MB, o, crit, m) in {
            "jax": (JaxDataSet, JaxSample, JaxSampleToMiniBatch, joptim,
                    jnn.SequenceCrossEntropyCriterion(), ref),
            "port": (DataSet, Sample, SampleToMiniBatch, optim,
                     nn.SequenceCrossEntropyCriterion(), port)}.items():
        (JaxRandomGenerator if pkg == "jax" else RandomGenerator) \
            .set_seed(4)
        opt = o.LocalOptimizer(
            m, mod_ds.array([S(x[i], y[i]) for i in range(len(x))])
            .transform(MB(8)), crit, batch_size=8)
        opt.set_optim_method(o.SGD(learning_rate=0.1))
        opt.set_precision("bf16_mixed")
        losses = {}

        def end(s, r=losses):
            r[s["neval"]] = s.get("Loss")
            return s["neval"] > 3

        opt.set_end_when(o.Trigger(end))
        opt.optimize()
        losses.pop(1)
        runs[pkg] = (losses, m.get_parameters())
    (jl, jparams), (pl, pparams) = runs["jax"], runs["port"]
    assert sorted(jl) == sorted(pl) == [2, 3, 4]
    for n in jl:
        np.testing.assert_allclose(pl[n], jl[n], rtol=5e-3)
    assert_trees_close(pparams, jax.tree.map(np.asarray, jparams),
                       atol=2e-3)
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_resnet20_bf16_step_matches_jax():
    """A CIFAR ResNet-20 ``build_train_step`` step of 4 rows under
    bf16_mixed in both packages (BN's statistics float32 islands, the
    running buffers float32): the loss within 1e-2 relative (measured
    2.0e-3), the parameters within 5e-3 (measured 1.8e-3; float32 alone
    gives 5.7e-5 on this ill-conditioned BN step) and the BN statistics
    within 1e-2 (measured 3.1e-3 on a running variance of 1.16, where a
    bfloat16 step of the batch variance is 7.8e-3)."""
    from bigdl_tpu.models.resnet import ResNet as JaxResNet
    from bigdl_tpu_torch.models import ResNet
    port = ResNet(10, depth=20, dataset="CIFAR10", device="cpu",
                  generator=torch.Generator().manual_seed(2))
    ref = JaxResNet(10, depth=20, dataset="CIFAR10")
    ref.set_parameters(jax.tree.map(jnp.asarray, port.get_parameters()))
    ref.set_state(jax.tree.map(jnp.asarray, port.get_state()))
    r = np.random.RandomState(3)
    x = r.rand(4, 3, 32, 32).astype(np.float32)
    y = r.randint(1, 11, 4).astype(np.float32)
    j_sgd = joptim.SGD(learning_rate=0.1, momentum=0.9)
    j_step = jax_train_step(ref.training(), jnn.CrossEntropyCriterion(),
                            j_sgd,
                            precision=jprec.PrecisionPolicy.bf16_mixed())
    jp = ref.get_parameters()
    jp, _, jms, jl = j_step(jp, j_sgd.init_state(jp), ref.get_state(),
                            jax.random.PRNGKey(0), 0.1, x, y)
    step = build_train_step(port, nn.CrossEntropyCriterion(),
                            optim.SGD(learning_rate=0.1, momentum=0.9),
                            precision=prec.PrecisionPolicy.bf16_mixed())
    pl = float(step(torch.from_numpy(x), torch.from_numpy(y), 0.1))
    np.testing.assert_allclose(pl, float(jl), rtol=1e-2)
    assert_trees_close(port.get_parameters(), jax.tree.map(np.asarray, jp),
                       atol=5e-3)
    assert_trees_close(port.get_state(), jax.tree.map(np.asarray, jms),
                       atol=1e-2)
    assert all(b.dtype == torch.float32 for b in port.buffers())
