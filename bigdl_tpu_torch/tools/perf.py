"""Throughput harness for the zoo's models on synthetic data (counterpart
of ``bigdl_tpu.tools.perf``; reference models/utils/DistriOptimizerPerf
.scala:38 and LocalOptimizerPerf.scala)::

    python -m bigdl_tpu_torch.tools.perf --model vgg16 --batch-size 64 \\
        --iterations 10 --dtype f32 [--mode train|inference] [--quantize]
    python -m bigdl_tpu_torch.tools.perf --model lenet --device cpu --iterations 3

One seeded batch (``tools.synthetic``) stays on the device; each
iteration is one train step of SGD (lr 0.01, momentum 0.9) on
CrossEntropyCriterion (SequenceCrossEntropyCriterion for the
transformer), or one evaluation forward, and ends on a value read back
to the host. Prints the JAX tool's lines (a header, ``iter i: ms
img/s`` per timed iteration, ``median: ...``) and its JSON tail, with
the JAX tool's keys where they apply. In place of its MFU (built on the
JAX package's compiled-program cost analysis) the median line and the
tail carry the analytic FLOPs a step, counted from the layer shapes
(:func:`flops_per_step`), and the rate they give.

``--dtype bf16`` (the JAX tool's default) is the legacy Engine knob:
``utils.engine.set_compute_dtype(bfloat16)`` for the run, put back
after; ``--precision`` names a full policy and wins over ``--dtype``.
``--kernels on|off`` scopes ``kernels.use(KernelConfig.all_on() |
off())`` over the run. ``--steps-per-sync K`` runs train steps K to a
host sync through :func:`~bigdl_tpu_torch.optim.make_host_window` (one
CUDA graph a window on the card). ``--device`` is the port's:
``cuda`` (default; raises without a card) or ``cpu``.

``--zero STAGE`` (train mode) trains over a data-parallel mesh of every
rank of the launched world (``tools.launch --nproc N``; one process
alone is a world of one), each rank stepping its slice of the batch
under ``ZeroConfig(STAGE)``; the rate and ``achieved_tflops`` are the
global batch's (every rank's rows, one step's time), and the tail
carries the per-rank
``params_bytes_per_chip`` / ``opt_state_bytes_per_chip`` gauges,
``zero_stage`` and ``zero_devices``, and a batch the world does not
divide exits, as the JAX tool does.

Not ported yet (each raises NotImplementedError naming its ROADMAP
queue 1 item): ``--metrics-jsonl`` (item 12), ``--sync-compare`` and
``--config`` (item 14).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bigdl_tpu_torch import telemetry

__all__ = ["Runner", "build_model", "flops_per_step", "main", "measure",
           "parse_args", "prepare"]

_ITER_S = telemetry.histogram(
    "tools/perf/iteration_s", "seconds per timed perf iteration")
_WARMUP_S = telemetry.histogram(
    "tools/perf/warmup_s", "seconds per warm-up iteration")

#: the flags of the JAX tool that wait for a later slice
_NOT_PORTED = {"metrics_jsonl": ("--metrics-jsonl", 12,
                                 "the telemetry snapshot export"),
               "sync_compare": ("--sync-compare", 14,
                                "the K = 1 against K = 8 comparison"),
               "config": ("--config", 14, "tuned.json artifacts from "
                          "tools.autotune")}


def build_model(name: str, class_num: int = 1000, device="cuda",
                generator: Optional[torch.Generator] = None):
    """``(model, input shape, classes)`` for a model name of the JAX
    tool (``bigdl_tpu/tools/perf.py:28-56``): lenet, vgg16, vgg19,
    resnet<depth>, alexnet (227 x 227), alexnet_owt, inception_v1 (the
    full model, with its two auxiliary heads), inception_v2 (without
    them) and transformer."""
    from bigdl_tpu_torch import models

    g = dict(device=device, generator=generator)
    name = name.lower()
    if name in ("lenet", "lenet5"):
        return models.LeNet5(10, **g), (1, 28, 28), 10
    if name in ("vgg16", "vgg_16"):
        return models.Vgg_16(class_num, **g), (3, 224, 224), class_num
    if name in ("vgg19", "vgg_19"):
        return models.Vgg_19(class_num, **g), (3, 224, 224), class_num
    if name.startswith("resnet"):
        depth = int(name[len("resnet"):] or 50)
        return (models.ResNet(class_num, depth=depth, dataset="ImageNet",
                              **g), (3, 224, 224), class_num)
    if name in ("alexnet", "alexnetowt", "alexnet_owt"):
        make = models.AlexNet if name == "alexnet" else models.AlexNet_OWT
        size = 227 if name == "alexnet" else 224
        return make(class_num, **g), (3, size, size), class_num
    if name in ("inception_v2", "inception-v2", "inceptionv2"):
        return (models.Inception_v2_NoAuxClassifier(class_num, **g),
                (3, 224, 224), class_num)
    if name.startswith("inception"):
        return models.Inception_v1(class_num, **g), (3, 224, 224), class_num
    if name.startswith("transformer"):
        return (models.TransformerLM(vocab_size=32000, hidden_size=512,
                                     num_layers=6, num_heads=8, max_len=512,
                                     **g), (512,), 32000)
    raise ValueError(f"unknown model {name}")


def _layer_flops(model, x) -> tuple:
    """``(forward FLOPs, data-gradient FLOPs)`` of ``model``'s
    convolutions and linear layers (float and int8) on ``x``: one
    evaluation forward under forward hooks, ``2 * outputs * depth`` a
    layer. The data gradient leaves out the layers that take none: the
    ones fed the model's input itself and ``propagate_back=False``."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    from bigdl_tpu_torch.nn.linear import Linear
    from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                              QuantizedSpatialConvolution)

    convs = (SpatialConvolution, QuantizedSpatialConvolution)
    linears = (Linear, QuantizedLinear)
    totals = [0, 0]

    def hook(module, inputs, out):
        if isinstance(module, convs):
            depth = (module.n_input_plane // module.n_group
                     * module.kernel_h * module.kernel_w)
        else:
            depth = module.input_size
        flops = 2 * out.numel() * depth
        totals[0] += flops
        fed_input = inputs[0].data_ptr() == x.data_ptr()
        if not fed_input and getattr(module, "propagate_back", True):
            totals[1] += flops

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, convs + linears)]
    training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
        model.train(training)
    return totals[0], totals[1]


def flops_per_step(model, x, train: bool) -> int:
    """Analytic FLOPs of one step on the batch ``x``, from the layer
    shapes: the forward's, and in training twice again less the data
    gradients no layer takes (:func:`_layer_flops`: the weight gradient
    and the data gradient each cost the forward's products). The
    TransformerLM from its widths: per token and layer ``2 (4 H^2 + 2 H
    F)`` and the attention's ``4 S H`` (the whole square), and the
    tied head's ``2 H V``, three times over in training. Normalization,
    pooling and elementwise passes are not counted."""
    from bigdl_tpu_torch.models import TransformerLM

    if isinstance(model, TransformerLM):
        b, s = x.shape[0], x.shape[-1]
        h, f, v = model.hidden_size, model.ffn_size, model.vocab_size
        tokens = b * s
        fwd = (model.num_layers * (2 * tokens * (4 * h * h + 2 * h * f)
                                   + 4 * b * s * s * h)
               + 2 * tokens * h * v)
        return 3 * fwd if train else fwd
    fwd, data_grad = _layer_flops(model, x)
    return 2 * fwd + data_grad if train else fwd


class Runner(NamedTuple):
    """One prepared measurement: ``run()`` does one iteration (a train
    step, a window of steps or a forward) and returns a tensor that
    :func:`measure` reads back to the host."""
    run: Callable[[], torch.Tensor]
    records_per_iter: int
    unit: str
    steps_per_sync: int
    flops_per_iter: int
    dtype: str
    device: torch.device
    #: ``--zero``'s fields for the JSON tail
    zero_meta: Optional[dict] = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--mode", choices=["train", "inference"],
                    default="train")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="bf16",
                    help="legacy Engine compute-dtype knob; ignored when "
                    "--precision names a policy")
    ap.add_argument("--precision", default=None,
                    choices=["f32", "bf16_mixed", "f16_mixed"],
                    metavar="POLICY",
                    help="precision policy preset (PrecisionPolicy.named)")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 inference rewrite (inference mode only)")
    ap.add_argument("--steps-per-sync", type=int, default=1, metavar="K",
                    help="train mode: K steps a host sync (one CUDA graph a "
                    "window on the card)")
    ap.add_argument("--kernels", choices=["on", "off"], default=None,
                    metavar="{on,off}",
                    help="hand-written kernels all on, or all off (the "
                    "plain PyTorch versions); default: BIGDL_KERNELS")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--zero", type=int, choices=(0, 1, 2, 3), default=0,
                    metavar="STAGE",
                    help="train mode: ZeRO stage over a data mesh of every "
                    "rank of the launched world; the tail reports the "
                    "opt-state / params bytes per rank")
    ap.add_argument("--metrics-jsonl", default=None, metavar="PATH",
                    help="not ported yet (item 12)")
    ap.add_argument("--sync-compare", action="store_true",
                    help="not ported yet (item 14)")
    ap.add_argument("--config", default=None, metavar="TUNED_JSON",
                    help="not ported yet (item 14)")
    args = ap.parse_args(argv)
    for attr, (flag, item, what) in _NOT_PORTED.items():
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag}: {what} is not ported yet (ROADMAP queue 1, item "
                f"{item})")
    if args.steps_per_sync < 1:
        raise SystemExit("--steps-per-sync must be >= 1")
    if args.quantize and args.mode != "inference":
        raise SystemExit("--quantize is inference-only")
    return args


def prepare(args) -> Runner:
    """The model on ``args.device`` (weights from seed 42, as the JAX
    tool's ``RandomGenerator.set_seed(42)``), its batch on the device and
    the iteration to time. Call it under the run's dtype and kernel
    settings (:func:`main` does)."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.quantized import quantize
    from bigdl_tpu_torch.optim import (SGD, build_eval_step,
                                       build_train_step, make_host_window,
                                       seed_precision)
    from bigdl_tpu_torch.precision import PrecisionPolicy
    from bigdl_tpu_torch.tools import synthetic
    from bigdl_tpu_torch.utils.engine import model_device

    mesh = None
    if args.zero and args.mode == "train":
        mesh = _zero_mesh(args)
    model, in_shape, class_num = build_model(
        args.model, device=_rank_device(args.device, mesh),
        generator=torch.Generator().manual_seed(42))
    device = model_device(model)
    is_lm = len(in_shape) == 1
    if is_lm:
        xs, ys = synthetic.token_batch(args.batch_size, in_shape[0],
                                       class_num)
        criterion = nn.SequenceCrossEntropyCriterion()
    else:
        xs, ys = synthetic.image_batch(args.batch_size, in_shape, class_num)
        criterion = nn.CrossEntropyCriterion()
    if mesh is not None:
        # this rank's rows of the global batch
        n, r = mesh.shape["data"], mesh.axis_index("data")
        rows = args.batch_size // n
        xs, ys = xs[r * rows:(r + 1) * rows], ys[r * rows:(r + 1) * rows]
    x = torch.from_numpy(xs).to(device)
    y = torch.from_numpy(ys).to(device)
    policy = (PrecisionPolicy.named(args.precision) if args.precision
              else PrecisionPolicy.from_engine())
    train = args.mode == "train"
    if args.quantize:
        model = quantize(model.eval())
    # the global batch's operations: on a mesh every rank counts its
    # rows, so the rate and the TFLOP/s are both the global batch's
    flops = flops_per_step(model, x, train) * (
        1 if mesh is None else mesh.shape["data"])
    k = args.steps_per_sync if train else 1
    zero_meta = None
    if train:
        from bigdl_tpu_torch.parallel import ZeroConfig, tree_bytes
        from bigdl_tpu_torch.parallel.zero import record_memory_gauges
        step = build_train_step(model, criterion,
                                SGD(learning_rate=0.01, momentum=0.9),
                                precision=policy, mesh=mesh,
                                zero=ZeroConfig(args.zero)
                                if args.zero else None)
        seed_precision(step)
        if args.zero:
            held = step.memory() if hasattr(step, "memory") else (
                tree_bytes(model.parameters()), tree_bytes([step.opt_state]))
            zero_meta = dict(record_memory_gauges(*held),
                             zero_stage=args.zero,
                             zero_devices=mesh.shape["data"] if mesh
                             is not None else 1)
        if k > 1:
            window = make_host_window(step)
            x_k = x.unsqueeze(0).expand(k, *x.shape)
            y_k = y.unsqueeze(0).expand(k, *y.shape)
            lrs = [0.01] * k

            def run():
                return window(x_k, y_k, lrs)
        else:
            def run():
                return step(x, y, 0.01)
    else:
        eval_step = build_eval_step(model, precision=policy)

        def run():
            return eval_step(x)
    prec = args.precision or args.dtype
    return Runner(run, args.batch_size * k
                  * (in_shape[0] if is_lm else 1),
                  "tok/s" if is_lm else "img/s", k, flops * k, prec,
                  device, zero_meta)


def _zero_mesh(args):
    """The data mesh over the launched world (started here when the
    environment names one), or None for a world of one; a batch the
    world does not divide exits."""
    import os

    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import data_parallel_mesh
    from bigdl_tpu_torch.utils import engine

    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        engine.init_distributed(
            backend="gloo" if args.device == "cpu" else None)
    mesh = data_parallel_mesh()
    ndev = mesh.shape["data"]
    if args.batch_size % ndev:
        raise SystemExit(
            f"--zero needs --batch-size divisible by the {ndev}-device "
            f"data mesh, got {args.batch_size}")
    return mesh if ndev > 1 else None


def _rank_device(device, mesh):
    from bigdl_tpu_torch.utils import engine
    return engine.rank_device(device) if mesh is not None else device


def _sync(out) -> float:
    """Read a value back (the JAX tool's rule: readiness alone can
    signal early)."""
    return float(out.float().sum())


def measure(runner: Runner, args) -> dict:
    """Time ``args.warmup`` then ``args.iterations`` iterations, print the
    JAX tool's lines and return its JSON tail's fields."""
    print(f"# {args.model} {args.mode} batch={args.batch_size} "
          f"dtype={runner.dtype} steps_per_sync={runner.steps_per_sync} "
          f"backend={runner.device.type}", flush=True)
    for _ in range(args.warmup):
        t0 = time.perf_counter()
        _sync(runner.run())
        _WARMUP_S.observe(time.perf_counter() - t0, model=args.model,
                          mode=args.mode)
    times = []
    for i in range(args.iterations):
        t0 = time.perf_counter()
        _sync(runner.run())
        dt = time.perf_counter() - t0
        _ITER_S.observe(dt, model=args.model, mode=args.mode)
        times.append(dt)
        print(f"iter {i}: {dt * 1000:.1f} ms  "
              f"{runner.records_per_iter / dt:.1f} {runner.unit}",
              flush=True)
    med = float(np.median(times))
    rate = runner.records_per_iter / med
    tflops = runner.flops_per_iter / med / 1e12
    print(f"median: {med * 1000:.1f} ms  {rate:.1f} {runner.unit}  |  "
          f"{runner.flops_per_iter / 1e9:.1f} GFLOP an iteration (layer "
          f"shapes), {tflops:.2f} TFLOP/s", flush=True)
    tail = {"tool": "perf", "model": args.model, "mode": args.mode,
            "batch_size": args.batch_size, "dtype": runner.dtype,
            "backend": runner.device.type, "median_s": med, "rate": rate,
            "steps_per_sync": runner.steps_per_sync,
            "flops_per_iteration": runner.flops_per_iter,
            "achieved_tflops": tflops}
    if args.mode == "train":
        tail["steps_per_sec"] = runner.steps_per_sync / med
    if runner.zero_meta:
        tail.update(runner.zero_meta)
    return tail


def main(argv=None) -> dict:
    """Parse, prepare, measure and print the JSON tail (returned too)."""
    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.utils import engine

    args = parse_args(argv)
    kernel_config = None
    if args.kernels is not None:
        kernel_config = (kernels.KernelConfig.all_on() if args.kernels == "on"
                         else kernels.KernelConfig.off())
    taken = telemetry.counter("kernels/dispatch/kernel")
    before = taken.total()
    saved_dtype = engine.compute_dtype()
    if args.precision is None:
        engine.set_compute_dtype(torch.bfloat16 if args.dtype == "bf16"
                                 else torch.float32)
    try:
        with kernels.use(kernel_config or kernels.get_config()):
            tail = measure(prepare(args), args)
            cfg = kernels.get_config()
            tail["kernels"] = ("on" if cfg.flash_attention
                               or cfg.decode_attention or cfg.int8_matmul
                               else "off")
    finally:
        engine.set_compute_dtype(saved_dtype)
    # the kernel label, as the JAX tool's: "cuda" only on evidence (a
    # dispatch taken in this run), "reference" for the forced-off leg
    tail["kernel_label"] = ("reference" if args.kernels == "off" else
                            "cuda" if taken.total() > before else None)
    print(json.dumps(tail), flush=True)
    return tail


if __name__ == "__main__":
    main()
