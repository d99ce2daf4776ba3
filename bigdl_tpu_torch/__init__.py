"""bigdl_tpu_torch — the PyTorch/CUDA port of ``bigdl_tpu`` for one
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``bigdl_tpu`` stays the reference; this package mirrors
its layout where a reader needs to find a module's counterpart and
never imports it (nor ``jax``). Plain tensor code is PyTorch; every
Pallas kernel on a ported path is a kernel written by hand for Hopper
under :mod:`bigdl_tpu_torch.kernels`.

Ported so far: TransformerLM generation serving —
:class:`~bigdl_tpu_torch.generation.GenerationService` →
:class:`~bigdl_tpu_torch.generation.loop.DecodeLoop` →
:class:`~bigdl_tpu_torch.generation.engine.DecodeEngine` →
:class:`~bigdl_tpu_torch.models.transformer.TransformerLM` with a KV
cache, whose decode step runs the ragged-decode CUDA kernel.

Entry points default to ``device="cuda"`` and raise when CUDA is
missing; they run on the CPU only when the caller passes
``device="cpu"`` (the CPU path runs each kernel's plain PyTorch
version).
"""
