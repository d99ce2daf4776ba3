"""Data parallelism and ZeRO on ``torch.distributed`` (the port's
``Optimizer(mesh=...)``, ``set_zero``) against the JAX package's mesh
runs: one gang of 2 gloo ranks on the CPU runs every scenario
(``_torch_dist_cases.data_parallel``), each rank feeding its own rows of
the packed synthetic corpus (uneven ``ignore_index`` padding over the
ranks), and the JAX package trains the same model from the same weights
on a 2-device data mesh of the conftest's virtual CPU devices.

Held within 1e-5 after 3 steps at every stage (0-3), SGD with momentum
and Adam (Adam's key bias ``bk`` by the losses only: its gradient is 0
in exact arithmetic, so each package's update of it is its own rounding
noise, see ``test_torch_optim``); bf16_mixed at stage 2 within the
precision tests' limits (2e-3); stages 1-3 bitwise stage 0 (two ranks
sum in one order); every rank's parameters equal; the gauges' n-fold
reduction; rank 0's stage-2 checkpoint resumed onto stage 3, in the
port's ``LocalOptimizer`` and in the JAX package's; validation counts
all-reduced; batch normalization's statistics over the global batch
(against the JAX package's mesh run) and dropout's masks drawn for the
global batch (against the port's one-process run); a batch that changes
size and a rank built from another seed raise; ``--sp`` at world 1
raises as the JAX CLI does."""
import jax
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import Sample as JSample
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.optim.evaluator import Evaluator as JEvaluator
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.parallel import ZeroConfig as JZeroConfig
from bigdl_tpu.parallel import make_mesh as jmake_mesh
from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
from bigdl_tpu_torch.convert import export_params
from bigdl_tpu_torch.models.transformer import train as transformer_train

import _torch_dist_cases as cases
from _torch_gang import run_gang
from _torch_parity import flat, to_jax

ATOL = 1e-5
#: bf16_mixed against the JAX package: the precision limits (the
#: parameters within test_torch_precision's 2e-3, the losses within
#: chip_smoke phase 11's relative 1e-2: two packages' bfloat16 roundings
#: of one step drift apart over three)
BF16_ATOL, BF16_LOSS_RTOL = 2e-3, 1e-2


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    ck = tmp / "ck"
    ck.mkdir()
    res = run_gang(cases.data_parallel, 2, tmp, str(ck), timeout=300)
    return res, ck


def _jax_run(x, y, *, stage=0, method="sgd", steps=cases.STEPS,
             precision=None, mesh_sizes=(2,), mesh_names=("data",),
             seq_parallel=None, ckdir=None, local=False, clip=None):
    JRandomGenerator.set_seed(4)
    model = JTransformerLM(**cases.LM)
    model.set_parameters(to_jax(export_params(cases.lm())))
    if isinstance(x, list):
        samples = [JSample([p[i] for p in x], y[i]) for i in range(len(y))]
    else:
        samples = [JSample(x[i], y[i]) for i in range(len(y))]
    ds = JDataSet.array(samples).transform(
        JSampleToMiniBatch(cases.GLOBAL_BATCH))
    crit = jnn.SequenceCrossEntropyCriterion(ignore_index=-1)
    if local:
        opt = joptim.LocalOptimizer(model, ds, crit,
                                    batch_size=cases.GLOBAL_BATCH)
    else:
        n = int(np.prod(mesh_sizes))
        mesh = jmake_mesh(list(mesh_sizes), list(mesh_names),
                          jax.devices()[:n])
        opt = joptim.Optimizer(model, ds, crit,
                               batch_size=cases.GLOBAL_BATCH, mesh=mesh)
    opt.set_optim_method(
        joptim.SGD(learning_rate=0.1, momentum=0.9) if method == "sgd"
        else joptim.Adam(learning_rate=1e-3))
    if stage:
        opt.set_zero(JZeroConfig(stage))
    if precision:
        opt.set_precision(precision)
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if seq_parallel:
        from bigdl_tpu.parallel import SeqParallelConfig
        opt.set_sequence_parallel(SeqParallelConfig(impl=seq_parallel))
    if ckdir is not None:
        opt.set_checkpoint(str(ckdir), joptim.several_iteration(100))
    losses = {}

    def end(state):
        losses[state["neval"]] = state.get("Loss")
        return state["neval"] > steps
    opt.set_end_when(JTrigger(end))
    opt.optimize()
    first = min(losses) + 1
    return ([losses[n] for n in range(first, steps + 2)],
            flat(model.get_parameters()))


def _assert_params(got, want, atol, skip_bk=False, msg=""):
    assert sorted(got) == sorted(want)
    for key in want:
        if skip_bk and key.endswith(".bk"):
            continue
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=f"{msg} {key}")


@pytest.mark.parametrize("method", ["sgd", "adam"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_stage_matches_the_jax_mesh_run(gang, stage, method):
    res, _ = gang
    x, y = cases.packed_rows()
    want_losses, want_params = _jax_run(x, y, stage=stage, method=method)
    got = res[0][(stage, method)]
    np.testing.assert_allclose(got["losses"], want_losses, atol=ATOL,
                               rtol=0)
    _assert_params(got["params"], want_params, ATOL,
                   skip_bk=method == "adam", msg=f"stage {stage}")
    # every rank holds the same parameters and driver state
    for k, v in res[1][(stage, method)]["params"].items():
        np.testing.assert_array_equal(v, got["params"][k])
    assert res[1][(stage, method)]["state"] == got["state"]
    # the rows are the global batch's
    assert got["rows"] == [cases.GLOBAL_BATCH] * cases.STEPS


@pytest.mark.parametrize("method", ["sgd", "adam"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stages_are_bitwise_stage_zero_on_two_ranks(gang, stage, method):
    """Two ranks sum in one order, and the update is elementwise, so a
    shard's update is the whole update's slice, bit for bit."""
    res, _ = gang
    got, ref = res[0][(stage, method)], res[0][(0, method)]
    assert got["losses"] == ref["losses"]
    for k in ref["params"]:
        np.testing.assert_array_equal(got["params"][k], ref["params"][k])


def test_bf16_mixed_stage2_matches_jax_and_stage0(gang):
    res, _ = gang
    x, y = cases.packed_rows()
    want_losses, want_params = _jax_run(x, y, stage=2,
                                        precision="bf16_mixed")
    got = res[0][(2, "bf16")]
    np.testing.assert_allclose(got["losses"], want_losses,
                               rtol=BF16_LOSS_RTOL)
    _assert_params(got["params"], want_params, BF16_ATOL, msg="bf16")
    ref = res[0][(0, "bf16")]
    np.testing.assert_allclose(got["losses"], ref["losses"], atol=BF16_ATOL)


@pytest.mark.parametrize("kind", ["f16", "clip"])
def test_f16_master_and_l2_clip_stage2_are_bitwise_stage0(gang, kind):
    """f16_mixed (float16 parameters, the float32 master shard, the
    loss scaler's global skip decision) at stage 2 is stage 0's bit for
    bit; the global L2 clip (its norm's squares summed a shard at a time,
    then over the ranks: another order) within 1e-7; both within their
    limits of the JAX package's mesh run."""
    res, _ = gang
    got, ref = res[0][(2, kind)], res[0][(0, kind)]
    if kind == "f16":
        assert got["losses"] == ref["losses"]
        for k in ref["params"]:
            np.testing.assert_array_equal(got["params"][k],
                                          ref["params"][k])
    else:
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-7)
        _assert_params(got["params"], ref["params"], 1e-7, msg="clip")
    x, y = cases.packed_rows()
    if kind == "clip":
        want_losses, want_params = _jax_run(x, y, stage=2, clip=0.5)
        np.testing.assert_allclose(got["losses"], want_losses, atol=ATOL)
        _assert_params(got["params"], want_params, ATOL, msg="clip")
    else:
        want_losses, want_params = _jax_run(x, y, stage=2,
                                            precision="f16_mixed")
        np.testing.assert_allclose(got["losses"], want_losses,
                                   rtol=BF16_LOSS_RTOL)
        _assert_params(got["params"], want_params, BF16_ATOL, msg="f16")


def test_memory_gauges_are_n_fold(gang):
    """The JAX test's n-fold reduction (tests/test_zero.py): the
    optimizer state halves at stage >= 1, the parameters at rest halve
    at stage 3 (every leaf of this model divides by 2)."""
    res, _ = gang
    mem = {s: res[0][(s, "adam")]["memory"] for s in (0, 1, 2, 3)}
    p0, o0 = (mem[0]["params_bytes_per_chip"],
              mem[0]["opt_state_bytes_per_chip"])
    t_bytes = 4                                  # Adam's int32 t
    for s in (1, 2, 3):
        assert mem[s]["opt_state_bytes_per_chip"] - t_bytes \
            == (o0 - t_bytes) // 2
    assert mem[1]["params_bytes_per_chip"] == p0
    assert mem[2]["params_bytes_per_chip"] == p0
    assert mem[3]["params_bytes_per_chip"] == p0 // 2


def test_checkpoint_resumes_onto_another_stage_and_in_both_packages(
        gang, tmp_path):
    import shutil

    from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.utils.random import RandomGenerator

    res, ck = gang
    # written when the trigger saw neval 3, after the 2nd step
    written = ck / f"checkpoint.{cases.STEPS}"
    assert written.exists()
    want = res[0]["uninterrupted"]
    resumed = res[0]["ck_resumed"]
    _assert_params(resumed["params"], want["params"], 1e-6, msg="stage 3")
    # the port's one-process LocalOptimizer resumes it
    mine = tmp_path / "port"
    mine.mkdir()
    shutil.copytree(written, mine / written.name)
    x, y = cases.packed_rows()
    model = cases.lm()
    RandomGenerator.set_seed(4)
    opt = LocalOptimizer(model, DataSet.array(cases._samples(x, y))
                         .transform(SampleToMiniBatch(cases.GLOBAL_BATCH)),
                         SequenceCrossEntropyCriterion(ignore_index=-1),
                         batch_size=cases.GLOBAL_BATCH)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    opt.set_checkpoint(str(mine), max_iteration(100))
    opt.set_end_when(max_iteration(cases.STEPS + 1))
    opt.optimize()
    assert opt.resumed_from["neval"] == cases.STEPS
    _assert_params(cases.flat_params(model), want["params"], ATOL,
                   msg="port local")
    # and the JAX package's
    theirs = tmp_path / "jax"
    theirs.mkdir()
    shutil.copytree(written, theirs / written.name)
    _, jparams = _jax_run(x, y, steps=cases.STEPS + 1, ckdir=theirs,
                          local=True)
    _assert_params(jparams, want["params"], ATOL, msg="jax local")


def test_validation_counts_are_all_reduced(gang):
    """Each rank scored its share; the summed mean loss is the
    one-process Evaluator's over every row, with the parameters after
    the step (a sequence output has no Top1: its argmax rows are not its
    targets' shape)."""
    res, _ = gang
    vx, vy = cases.contiguous_rows(8)
    model = JTransformerLM(**cases.LM)
    model.set_parameters(to_jax(res[0]["validated_params"]))
    samples = [JSample(vx[i], vy[i]) for i in range(len(vy))]
    got = JEvaluator(model).test(JDataSet.array(samples),
                                 [joptim.Loss(
                                     jnn.SequenceCrossEntropyCriterion())],
                                 batch_size=8)
    want = next(iter(got.values())).result()[0]
    assert res[0]["validation"]["Loss"] == pytest.approx(want, abs=ATOL)
    assert res[1]["validation"] == res[0]["validation"]


def _jax_bn_run(stage):
    """The batch-norm classifier on the JAX package's 2-device data
    mesh, from the port's weights: losses, parameters, state."""
    JRandomGenerator.set_seed(4)
    model = jnn.Sequential().add(jnn.Linear(6, 12)) \
        .add(jnn.BatchNormalization(12)).add(jnn.ReLU()) \
        .add(jnn.Linear(12, 3)).add(jnn.LogSoftMax())
    model.set_parameters(to_jax(export_params(cases.bn_mlp())))
    x, y = cases.mlp_rows()
    ds = JDataSet.array([JSample(x[i], y[i]) for i in range(len(y))]) \
        .transform(JSampleToMiniBatch(8))
    opt = joptim.Optimizer(model, ds, jnn.ClassNLLCriterion(), batch_size=8,
                           mesh=jmake_mesh([2], ["data"], jax.devices()[:2]))
    opt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
    if stage:
        opt.set_zero(JZeroConfig(stage))
    losses = {}

    def end(state):
        losses[state["neval"]] = state.get("Loss")
        return state["neval"] > cases.STEPS
    opt.set_end_when(JTrigger(end))
    opt.optimize()
    return ([losses[n] for n in range(2, cases.STEPS + 2)],
            flat(model.get_parameters()), flat(model.get_state()))


@pytest.mark.parametrize("stage", [0, 2])
def test_batch_norm_takes_the_global_batch_as_the_jax_mesh_run(gang, stage):
    """Each rank normalizes its 4 rows with the statistics of all 8, as
    the JAX package's SPMD program does, and every rank keeps the
    global running buffers."""
    res, _ = gang
    want_losses, want_params, want_state = _jax_bn_run(stage)
    np.testing.assert_allclose(res[0][("bn", stage)]["losses"], want_losses,
                               atol=ATOL, rtol=0)
    for r in (0, 1):
        got = res[r][("bn", stage)]
        _assert_params(got["params"], want_params, ATOL, msg=f"rank {r}")
        _assert_params(got["state"], want_state, ATOL, msg=f"rank {r}")


def test_dropout_draws_each_ranks_rows_of_the_global_mask(gang):
    """Every rank draws the global batch's masks and keeps its rows, so
    two ranks train as one process does on the concatenated batches
    (the JAX package's masks come from another generator, so the
    reference is the port's own one-process run)."""
    res, _ = gang
    want = res[0]["dropout_one_process"]
    np.testing.assert_allclose(res[0]["dropout"]["losses"], want["losses"],
                               atol=1e-6, rtol=0)
    for r in (0, 1):
        got = res[r]["dropout"]
        _assert_params(got["params"], want["params"], 1e-6, msg=f"rank {r}")
        _assert_params(got["state"], want["state"], 1e-6, msg=f"rank {r}")
    # the masks took effect
    assert not np.allclose(res[0]["dropout"]["losses"],
                           res[0][("bn", 0)]["losses"])


def test_a_batch_that_changes_size_raises(gang):
    res, _ = gang
    for r in (0, 1):
        assert "changed size 2 -> 3" in res[r]["resized"]


def test_moe_on_a_mesh_raises_naming_item_11(gang):
    res, _ = gang
    for r in (0, 1):
        assert "item 11" in res[r]["moe"]


def test_ranks_built_from_different_seeds_raise(gang):
    res, _ = gang
    for r in (0, 1):
        assert "start from different parameters" in res[r]["divergent"]


def test_sp_at_world_one_raises_as_the_jax_cli_does(monkeypatch):
    from bigdl_tpu.models.transformer import train as jtrain
    monkeypatch.setattr(jax, "devices", lambda *a: jax.local_devices()[:1])
    with pytest.raises(ValueError) as want:
        jtrain.build_mesh_for(1, 1, 2)
    monkeypatch.undo()
    with pytest.raises(ValueError) as got:
        transformer_train.main(["--synthetic", "3000", "--device", "cpu",
                                "--vocabSize", "64", "--seqLen", "16",
                                "--hiddenSize", "32", "--heads", "2",
                                "--layers", "1", "--sp", "ring"])
    assert str(got.value) == str(want.value)
