"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``bigdl_tpu`` stays the reference; this package mirrors
its layout where a reader needs to find a module's counterpart and
never imports it (nor ``jax``). Plain tensor code is PyTorch; every
Pallas kernel on a ported path is a kernel written by hand for Hopper
under :mod:`bigdl_tpu_torch.kernels`.

Ported so far:

- TransformerLM generation serving —
  :class:`~bigdl_tpu_torch.generation.GenerationService` →
  :class:`~bigdl_tpu_torch.generation.loop.DecodeLoop` →
  :class:`~bigdl_tpu_torch.generation.engine.DecodeEngine` →
  :class:`~bigdl_tpu_torch.models.transformer.TransformerLM` with a KV
  cache, whose decode step runs the ragged-decode CUDA kernel (K3);
- TransformerLM training on one card —
  :class:`~bigdl_tpu_torch.optim.LocalOptimizer` →
  :func:`~bigdl_tpu_torch.optim.build_train_step` → the model's forward
  and backward, whose attention runs the flash-attention CUDA kernels
  (K1, forward and backward) through
  :func:`bigdl_tpu_torch.kernels.attention`; the train CLI is
  :mod:`bigdl_tpu_torch.models.transformer.train`;
- long context: past the flash working-set budget attention runs the
  blockwise kernels (K2), and generation prefills long prompts in
  chunks;
- calibrated int8 serving —
  :class:`~bigdl_tpu_torch.serving.InferenceService` →
  :class:`~bigdl_tpu_torch.serving.MicroBatcher` → the registry's
  quantized load (:func:`~bigdl_tpu_torch.nn.quantized.quantize`,
  calibration and :class:`~bigdl_tpu_torch.precision.AccuracyGate`) of
  a :func:`~bigdl_tpu_torch.models.ResNet`, whose classifier runs the
  fused dequant int8 GEMM (K5); the paged decode kernel (K4) sits
  behind :func:`bigdl_tpu_torch.kernels.paged_decode_attention`;
- LeNet-5 training, validation and evaluation (BASELINE config 1) —
  :func:`~bigdl_tpu_torch.models.LeNet5` on the
  :class:`~bigdl_tpu_torch.nn.module.Module` contract (captured
  constructor arguments, names, gradient scales and freezing,
  regularizers, the JAX package's parameter tree), trained by
  :class:`~bigdl_tpu_torch.optim.LocalOptimizer` with validation
  triggers and scored by :class:`~bigdl_tpu_torch.optim.Evaluator` and
  :class:`~bigdl_tpu_torch.optim.Predictor`; the recipes are
  :mod:`bigdl_tpu_torch.models.lenet.train` and ``.test``. This path
  runs PyTorch's own convolutions and GEMMs (no Pallas kernel is on the
  JAX package's LeNet path either);
- ResNet training (BASELINE config 3: ResNet-50 on ImageNet shapes,
  batch 256) — :mod:`bigdl_tpu_torch.models.resnet.train` and
  ``.test``, BatchNormalization's training mode in the JAX package's op
  sequence, the ``EpochDecay`` schedules; and checkpoints in the JAX
  package's format 2 (:mod:`bigdl_tpu_torch.utils.serialization`,
  :mod:`~bigdl_tpu_torch.utils.module_serializer`): a run checkpointed
  by either package resumes in the other, and a module saved by either
  loads in the other (``ModelRegistry.load(path=)`` serves one);
- the optimizers — every OptimMethod of the JAX package (SGD, Adam,
  Adagrad, Adadelta, Adamax, RMSprop, Ftrl; LBFGS with strong-Wolfe)
  and its learning-rate schedules under :mod:`bigdl_tpu_torch.optim`,
  and ``Optimizer.optimize()``'s retry from the newest checkpoint with
  the classified backoff of :mod:`bigdl_tpu_torch.faults`;
- the rest of TransformerLM training — MoE blocks
  (:class:`~bigdl_tpu_torch.nn.MoE`) with the load-balance term in the
  train step's objective, attention dropout and the dropout layers on
  the step's own ``torch.Generator`` (replayed by CUDA-graph windows),
  an untied head, RMSNorm, the streaming packers, the PTB reader, and
  the recipes :mod:`bigdl_tpu_torch.models.transformer.train` (``-f``
  text, snapshots, checkpoints) and ``.test`` (perplexity).
- the rest of generation serving — prefix/KV reuse
  (:class:`~bigdl_tpu_torch.fleet.PrefixCache`, full-prompt and
  chunk-boundary hits), speculative decoding
  (:class:`~bigdl_tpu_torch.fleet.SpeculativeDecoder`, whose draft's
  decode steps run K3), replicas behind
  :class:`~bigdl_tpu_torch.fleet.FleetRouter`, ``apply_tuned_config``
  (:mod:`bigdl_tpu_torch.autotune`) and the fault points and seeded
  schedules of :mod:`bigdl_tpu_torch.faults`.

Entry points default to ``device="cuda"`` and raise when CUDA is
missing; they run on the CPU only when the caller passes
``device="cpu"`` (the CPU path runs each kernel's plain PyTorch
version).
"""

__version__ = "0.1.0"
