"""What each rank of the distributed tests runs (torch and the port
only: a spawned rank imports this module anew). Every function takes
``(rank, world, ...)`` after the process group is up and returns numpy
and plain values."""
import numpy as np
import torch

from bigdl_tpu_torch.convert import (export_params, export_state,
                                     flatten_params)
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import TransformerLM
from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.nn import (BatchNormalization, ClassNLLCriterion,
                                Dropout, Linear, LogSoftMax, ReLU,
                                SequenceCrossEntropyCriterion, Sequential)
from bigdl_tpu_torch.optim import (SGD, Adam, Loss, Optimizer,
                                   build_train_step, max_iteration,
                                   several_iteration)
from bigdl_tpu_torch.parallel import (SeqParallelConfig, ZeroConfig,
                                      make_mesh, ring_attention,
                                      ring_attention_sharded,
                                      ulysses_attention,
                                      ulysses_attention_sharded,
                                      use_sequence_parallel)
from bigdl_tpu_torch.utils.random import RandomGenerator

#: the small TransformerLM of the data-parallel cases
LM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
          max_len=16)
STEPS = 3
GLOBAL_BATCH = 4
METHODS = {"sgd": lambda: SGD(learning_rate=0.1, momentum=0.9),
           "adam": lambda: Adam(learning_rate=1e-3)}


def lm(seed=1, **kw):
    return TransformerLM(**{**LM, **kw}, device="cpu",
                         generator=torch.Generator().manual_seed(seed))


def packed_rows(n=GLOBAL_BATCH):
    """``n`` rows of the train CLI's packed synthetic documents: planes
    and targets (-1 at pads and boundaries, unevenly spread)."""
    x, y = transformer_train.synthetic_corpus(3000, LM["vocab_size"],
                                              LM["max_len"], "packed", 4)
    return [p[:n] for p in x], y[:n]


def contiguous_rows(n=GLOBAL_BATCH, seq=LM["max_len"]):
    x, y = transformer_train.synthetic_corpus(3000, LM["vocab_size"], seq,
                                              "contiguous", 4)
    return x[:n], y[:n]


def _samples(x, y):
    if isinstance(x, list):
        return [Sample([p[i] for p in x], y[i]) for i in range(len(y))]
    return [Sample(x[i], y[i]) for i in range(len(y))]


def flat_params(model):
    return {k: np.asarray(v) for k, v in
            flatten_params(export_params(model)).items()}


def _train(mesh, x, y, *, stage=0, method="sgd", steps=STEPS,
           precision=None, seq_parallel=None, ckdir=None, every=None,
           model=None, criterion=None, clip=None):
    nd = mesh.shape.get("data", 1)
    dr = mesh.axis_index("data")
    model = model or lm()
    RandomGenerator.set_seed(4)
    ds = DataSet.sharded(_samples(x, y), dr, nd).transform(
        SampleToMiniBatch(GLOBAL_BATCH // nd))
    opt = Optimizer(model, ds, criterion
                    or SequenceCrossEntropyCriterion(ignore_index=-1),
                    batch_size=GLOBAL_BATCH, mesh=mesh)
    opt.set_optim_method(METHODS[method]())
    if stage:
        opt.set_zero(ZeroConfig(stage))
    if precision:
        opt.set_precision(precision)
    if clip:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if seq_parallel:
        opt.set_sequence_parallel(SeqParallelConfig(impl=seq_parallel))
    if ckdir:
        opt.set_checkpoint(ckdir, several_iteration(every))
    opt.set_end_when(max_iteration(steps))
    opt.optimize()
    state = {k: v for k, v in opt.driver_state.items() if k != "Throughput"}
    return {"losses": [h["loss"] for h in opt.history],
            "params": flat_params(model), "state": state,
            "memory": getattr(opt, "memory", None),
            "rows": [h["rows"] for h in opt.history]}


def bn_mlp(dropout=0.0):
    """A small classifier with batch normalization (and dropout), the
    same weights on every rank."""
    g = torch.Generator().manual_seed(5)
    layers = [Linear(6, 12, generator=g), BatchNormalization(12, generator=g),
              ReLU()]
    if dropout:
        layers.append(Dropout(dropout))
    return Sequential(*layers, Linear(12, 3, generator=g), LogSoftMax())


def mlp_rows(n=24):
    """The classifier's rows: ``STEPS`` global batches of 8, one epoch
    (no reshuffle)."""
    r = np.random.RandomState(6)
    x = (r.randn(n, 6) * 2.0 + 0.5).astype(np.float32)
    y = (np.arange(n) % 3 + 1).astype(np.float32)
    return x, y


def rank_order(n, ranks, per_rank):
    """The rows a mesh's global batches hold, in order: each batch is
    every rank's next ``per_rank`` rows of its shard (``i % ranks ==
    rank``) concatenated in rank order."""
    shards = [list(range(r, n, ranks)) for r in range(ranks)]
    return [i for s in range(n // (ranks * per_rank)) for sh in shards
            for i in sh[s * per_rank:(s + 1) * per_rank]]


def _train_mlp(mesh, model, *, stage=0, steps=STEPS, batch=8):
    """``steps`` SGD steps of ``model`` on the MLP rows, this rank's
    share of each global batch of ``batch``; off a mesh, the global
    batches of a 2-rank mesh in its order: losses, parameters and
    batch-norm buffers."""
    nd = 1 if mesh is None else mesh.shape.get("data", 1)
    dr = 0 if mesh is None else mesh.axis_index("data")
    x, y = mlp_rows()
    if mesh is None:
        order = rank_order(len(y), 2, batch // 2)
        x, y = x[order], y[order]
    RandomGenerator.set_seed(4)
    ds = DataSet.sharded(_samples(x, y), dr, nd).transform(
        SampleToMiniBatch(batch // nd))
    opt = Optimizer(model, ds, ClassNLLCriterion(), batch_size=batch,
                    mesh=mesh)
    opt.set_optim_method(SGD(learning_rate=0.1, momentum=0.9))
    if stage:
        opt.set_zero(ZeroConfig(stage))
    opt.set_end_when(max_iteration(steps))
    opt.optimize()
    return {"losses": [h["loss"] for h in opt.history],
            "params": flat_params(model),
            "state": {k: np.asarray(v) for k, v in
                      flatten_params(export_state(model)).items()}}


# ------------------------------------------------------ data parallelism

def data_parallel(rank, world, ckdir):
    """Every data-parallel scenario of ``test_torch_distributed`` in one
    gang of 2 ranks."""
    mesh = make_mesh([world], ["data"])
    x, y = packed_rows()
    out = {}
    for stage in (0, 1, 2, 3):
        for method in METHODS:
            out[(stage, method)] = _train(mesh, x, y, stage=stage,
                                          method=method)
    for stage in (0, 2):
        out[(stage, "bf16")] = _train(mesh, x, y, stage=stage,
                                      precision="bf16_mixed")
        # float16 parameters with the float32 master shard and the loss
        # scaler; and the global L2 clip over shards
        out[(stage, "f16")] = _train(mesh, x, y, stage=stage,
                                     precision="f16_mixed")
        out[(stage, "clip")] = _train(mesh, x, y, stage=stage, clip=0.5)
    # a stage-2 checkpoint at neval 3, resumed onto stage 3 for the
    # last two steps, beside the uninterrupted 4 steps
    out["ck_written"] = _train(mesh, x, y, stage=2, steps=STEPS,
                               ckdir=ckdir, every=STEPS)
    out["ck_resumed"] = _train(mesh, x, y, stage=3, steps=STEPS + 1,
                               ckdir=ckdir, every=100)
    out["uninterrupted"] = _train(mesh, x, y, stage=2, steps=STEPS + 1)
    # validation: each rank scores its share, the counts all-reduced
    vx, vy = contiguous_rows(8)
    model = lm()
    RandomGenerator.set_seed(4)
    opt = Optimizer(model, DataSet.sharded(_samples(x, y), rank, world)
                    .transform(SampleToMiniBatch(2)),
                    SequenceCrossEntropyCriterion(ignore_index=-1),
                    batch_size=GLOBAL_BATCH, mesh=mesh)
    opt.set_optim_method(SGD(learning_rate=0.1))
    opt.set_validation(several_iteration(1),
                       DataSet.sharded(_samples(vx, vy), rank, world),
                       [Loss(SequenceCrossEntropyCriterion())],
                       batch_size=2)
    opt.set_end_when(max_iteration(1))
    opt.optimize()
    out["validation"] = opt.validation_history[-1]
    out["validated_params"] = export_params(model)
    # a batch that changes size
    step = build_train_step(lm(), SequenceCrossEntropyCriterion(),
                            SGD(learning_rate=0.1), mesh=mesh)
    cx, cy = contiguous_rows(6)
    step(torch.from_numpy(cx[:2]), torch.from_numpy(cy[:2]), 0.1)
    try:
        step(torch.from_numpy(cx[2:5]), torch.from_numpy(cy[2:5]), 0.1)
        out["resized"] = None
    except ValueError as e:
        out["resized"] = str(e)
    # MoE blocks on a mesh wait for expert parallelism
    try:
        build_train_step(lm(moe_experts=2), SequenceCrossEntropyCriterion(),
                         SGD(learning_rate=0.1), mesh=mesh)
        out["moe"] = None
    except NotImplementedError as e:
        out["moe"] = str(e)
    # batch normalization takes the global batch's statistics, and
    # dropout draws this rank's rows of the global mask: against the
    # JAX package's mesh run, and against the one-process run
    for stage in (0, 2):
        out[("bn", stage)] = _train_mlp(mesh, bn_mlp(), stage=stage)
    out["dropout"] = _train_mlp(mesh, bn_mlp(0.3))
    out["dropout_one_process"] = _train_mlp(None, bn_mlp(0.3))
    # a rank built from another seed fails at the start
    try:
        _train(mesh, x, y, model=lm(seed=1 + rank), steps=1)
        out["divergent"] = None
    except ValueError as e:
        out["divergent"] = str(e)
    return out


# -------------------------------------------------- sequence parallelism

def _qkv(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def attention(rank, world, shape, seg_len):
    """Ring and Ulysses over a ``seq`` axis of every rank: this rank's
    slice of the outputs and of the input gradients of ``sum(out * g)``,
    causal and not, with and without packed segments, plus the
    whole-array wrappers, the adopted policy, the indivisible heads and
    the ring's backward without its last hop."""
    import importlib

    from bigdl_tpu_torch.nn.attention import MultiHeadAttention

    # the package's ring_attention is the function; the module by name
    ring_mod = importlib.import_module(
        "bigdl_tpu_torch.parallel.ring_attention")

    mesh = make_mesh([world], ["seq"])
    q, k, v, g = _qkv(shape, 0)
    b, h, s, d = shape
    n = s // world
    sl = slice(rank * n, (rank + 1) * n)
    seg = np.repeat(np.arange(s // seg_len), seg_len)[None].repeat(b, 0) \
        .astype(np.int32) + 1
    out = {}
    for impl, fn in (("ring", ring_attention), ("ulysses",
                                                ulysses_attention)):
        for causal in (False, True):
            for packed in (False, True):
                t = [torch.from_numpy(a[:, :, sl].copy()).requires_grad_()
                     for a in (q, k, v)]
                o = fn(*t, axis_name="seq", mesh=mesh, causal=causal,
                       segments=torch.from_numpy(seg[:, sl].copy())
                       if packed else None)
                (o * torch.from_numpy(g[:, :, sl].copy())).sum().backward()
                out[(impl, causal, packed)] = [o.detach().numpy()] + [
                    a.grad.numpy() for a in t]
    full = [torch.from_numpy(a) for a in (q, k, v)]
    out["ring_sharded"] = ring_attention_sharded(
        *full, mesh, causal=True).detach().numpy()
    out["ulysses_sharded"] = ulysses_attention_sharded(
        *full, mesh, causal=True).detach().numpy()
    # a module without ring_axis adopts the installed policy
    torch.manual_seed(0)
    mha = MultiHeadAttention(d * h, h, causal=True,
                             generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        b, s, d * h).astype(np.float32))
    dense = mha(x)[:, sl].detach().numpy()
    with use_sequence_parallel(SeqParallelConfig(impl="ring", mesh=mesh)):
        adopted = mha(x[:, sl]).detach().numpy()
    out["adopted"] = (adopted, dense)
    # heads that do not divide the axis
    try:
        ulysses_attention(*(a[:, :1] for a in full[:3]), mesh=mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # the ring's backward without its last hop must come out wrong
    saved = ring_mod._return_hop
    ring_mod._return_hop = lambda ts, group: list(ts)
    try:
        t = [torch.from_numpy(a[:, :, sl].copy()).requires_grad_()
             for a in (q, k, v)]
        o = ring_attention(*t, mesh=mesh, causal=True)
        (o * torch.from_numpy(g[:, :, sl].copy())).sum().backward()
        out["no_last_hop"] = [a.grad.numpy() for a in t]
    finally:
        ring_mod._return_hop = saved
    return out


def data_by_seq(rank, world):
    """data = 2 x seq = 2 at ZeRO stage 2, ring and Ulysses, and the
    uneven padding over a seq axis of every rank."""
    out = {}
    mesh = make_mesh([2, 2], ["data", "seq"])
    x, y = contiguous_rows()
    for impl in ("ring", "ulysses"):
        out[impl] = _train(mesh, x, y, stage=2, seq_parallel=impl)
    # padding on the first half of the sequence only: with 4 seq ranks
    # ranks 0 and 1 hold all of it
    mesh4 = make_mesh([1, world], ["data", "seq"])
    py = y.copy()
    py[:, : LM["max_len"] // 2 - 2] = -1
    out["padded"] = _train(mesh4, x, py, seq_parallel="ring", steps=2)
    return out
