"""ZeRO's configuration and shard plan (``bigdl_tpu_torch.parallel.zero``)
against the JAX package's ``bigdl_tpu.parallel.zero``, with no process
started: ``ZeroConfig``'s validation and ``active_on``; ``extend_spec``
and ``tree_zero_specs`` spec for spec over every TransformerLM leaf on
data meshes of 2 and 4 (the JAX package's ``tuple(PartitionSpec)``);
the n-fold bytes a rank holds (the port's shard views against
``tree_bytes_per_chip`` of the JAX package's placed tree); the memory
gauges; ``apply_tuned_optimizer`` on a stub Optimizer, call for call the
JAX package's."""
import jax
import numpy as np
import pytest
import torch

from bigdl_tpu.autotune import config as jconfig
from bigdl_tpu.models.transformer import TransformerLM as JTransformerLM
from bigdl_tpu.parallel import make_mesh as jmake_mesh
from bigdl_tpu.parallel import zero as jzero
from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.autotune import config as pconfig
from bigdl_tpu_torch.convert import export_params, flatten_params
from bigdl_tpu_torch.parallel import (Mesh, ZeroConfig, extend_spec,
                                      record_memory_gauges, shard_dim,
                                      shard_view, tree_bytes,
                                      tree_zero_specs)

import _torch_dist_cases as cases

from _torch_parity import to_jax

#: the training slice's width at 2 layers and the tests' small model
WIDTHS = [dict(cases.LM),
          dict(vocab_size=32000, hidden_size=512, num_layers=2,
               num_heads=8, ffn_size=2048, max_len=512)]


def _jax_mesh(n):
    return jmake_mesh([n], ["data"], jax.devices()[:n])


@pytest.mark.parametrize("stage", [-1, 4])
def test_stage_out_of_range_raises_as_jax(stage):
    with pytest.raises(ValueError) as want:
        jzero.ZeroConfig(stage=stage)
    with pytest.raises(ValueError) as got:
        ZeroConfig(stage=stage)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_active_on_matches_jax(stage, n):
    port = ZeroConfig(stage=stage).active_on(Mesh([n], ["data"]))
    want = jzero.ZeroConfig(stage=stage).active_on(_jax_mesh(n))
    assert port == want
    assert ZeroConfig(stage=stage).active_on(None) is False
    # a mesh without the axis (pure sequence parallelism)
    assert ZeroConfig(stage=stage).active_on(Mesh([n], ["seq"])) is False


@pytest.mark.parametrize("shape", [(), (7,), (8,), (6, 4), (3, 8), (5, 3),
                                   (0, 4), (4, 0, 8), (2, 2, 2)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_extend_spec_matches_jax(shape, n):
    from jax.sharding import PartitionSpec as P
    want = tuple(jzero.extend_spec(P(), shape, n, "data"))
    assert extend_spec((), shape, n, "data") == want
    d = shard_dim(shape, n)
    assert (d is None) == ("data" not in want)
    if d is not None:
        assert want[d] == "data"
    # a base that already uses the axis is kept
    assert extend_spec(("data",), shape, n, "data") == ("data",)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("width", range(len(WIDTHS)), ids=["small", "full"])
def test_tree_zero_specs_match_jax_leaf_by_leaf(width, n):
    geom = WIDTHS[width]
    if width == 0:      # the port's own leaves
        shapes = {k: tuple(v.shape) for k, v in
                  flatten_params(export_params(cases.lm())).items()}
    else:               # full width: shapes only, no weights made
        shapes = _shapes(geom)
    got = tree_zero_specs(shapes, Mesh([n], ["data"]), ZeroConfig(2))
    tree = jax.eval_shape(lambda: JTransformerLM(**geom).init(
        jax.random.PRNGKey(0)))
    want = flatten_params(jzero.tree_zero_specs(
        tree, _jax_mesh(n), jzero.ZeroConfig(2)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), k


def _shapes(geom):
    """Leaf shapes of a TransformerLM of ``geom``, from the JAX
    package's abstract init (no weights are made)."""
    tree = jax.eval_shape(lambda: JTransformerLM(**geom).init(
        jax.random.PRNGKey(0)))
    return {k: tuple(v.shape) for k, v in flatten_params(tree).items()}


@pytest.mark.parametrize("n", [2, 4])
def test_bytes_a_rank_holds_are_n_fold(n):
    """Each rank's shard views of the small model's parameters hold the
    JAX package's per-chip bytes of the same tree placed in its ZeRO
    layout: ``1/n`` of every leaf that divides."""
    model = cases.lm()
    named = dict(model.named_parameters())
    tree = export_params(model)
    placed = jzero.shard_zero_tree(to_jax(tree), _jax_mesh(n),
                                   jzero.ZeroConfig(2))
    want = jzero.tree_bytes_per_chip(placed)
    for r in range(n):
        views = [shard_view(p.detach(), shard_dim(tuple(p.shape), n), r, n)
                 for p in named.values()]
        assert tree_bytes(views) == want
    assert tree_bytes(named.values()) == jzero.tree_bytes_per_chip(
        to_jax(tree))


def test_memory_gauges():
    got = record_memory_gauges(1024, 4096)
    assert got == {"params_bytes_per_chip": 1024,
                   "opt_state_bytes_per_chip": 4096}
    assert telemetry.gauge(
        "train/memory/params_bytes_per_chip").value() == 1024
    assert telemetry.gauge(
        "train/memory/opt_state_bytes_per_chip").value() == 4096


class _Stub:
    def __init__(self):
        self.calls = []

    def set_steps_per_sync(self, k):
        self.calls.append(("set_steps_per_sync", k))
        return self

    def set_zero(self, cfg):
        self.calls.append(("set_zero", None if cfg is None
                           else (cfg.stage, cfg.data_axis)))
        return self

    def set_precision(self, p):
        self.calls.append(("set_precision", p))
        return self


@pytest.mark.parametrize("winner", [
    {"steps_per_sync": 8, "zero_stage": 2, "precision": "bf16_mixed"},
    {"zero_stage": 0, "precision": "f32"},
    {"steps_per_sync": 1},
    {}])
def test_apply_tuned_optimizer_calls_as_jax(winner):
    def tuned(mod):
        fp = mod.Fingerprint(device_kind="cpu", platform="cpu",
                             device_count=1, mesh_shape=(1,),
                             package_version="0")
        return mod.TunedConfig(fingerprint=fp, seed=0,
                               winners={"train": dict(winner)})
    want, got = _Stub(), _Stub()
    assert jconfig.apply_tuned_optimizer(tuned(jconfig), want) is want
    assert pconfig.apply_tuned_optimizer(tuned(pconfig), got) is got
    assert got.calls == want.calls


def test_apply_tuned_optimizer_drives_a_real_optimizer():
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import Optimizer
    fp = pconfig.Fingerprint(device_kind="cpu", platform="cpu",
                             device_count=1, mesh_shape=(1,),
                             package_version="0")
    cfg = pconfig.TunedConfig(fingerprint=fp, seed=0, winners={
        "train": {"steps_per_sync": 4, "zero_stage": 3,
                  "precision": "bf16_mixed"}})
    opt = Optimizer(cases.lm(), DataSet.array([]),
                    SequenceCrossEntropyCriterion())
    pconfig.apply_tuned_optimizer(cfg, opt)
    assert opt.steps_per_sync == 4
    assert opt.zero_config == ZeroConfig(3)
    assert opt._precision.name == "bf16_mixed"
    with pytest.raises(NotImplementedError, match="item 11"):
        Optimizer(cases.lm(), DataSet.array([]),
                  SequenceCrossEntropyCriterion(), sharding_rules=[])
    assert torch.is_tensor(next(opt.model.parameters()))
