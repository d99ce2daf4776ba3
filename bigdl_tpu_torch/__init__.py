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
  :mod:`bigdl_tpu_torch.models.transformer_train`;
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
  behind :func:`bigdl_tpu_torch.kernels.paged_decode_attention`.

Entry points default to ``device="cuda"`` and raise when CUDA is
missing; they run on the CPU only when the caller passes
``device="cpu"`` (the CPU path runs each kernel's plain PyTorch
version).
"""
