"""Kernel selection policy: which hand-written kernels the dispatch
layer may select (counterpart of ``bigdl_tpu.kernels.config``).

A :class:`KernelConfig` names the kernels :mod:`bigdl_tpu_torch.kernels.
dispatch` may take; an op switched off runs the einsum path instead
(the JAX package's kernels-off configuration, chosen explicitly — not a
fallback). The ``BIGDL_KERNELS`` env var overrides the default without
touching code, with the JAX package's grammar:

- ``BIGDL_KERNELS=1`` / ``on`` / ``all`` / ``true`` — every kernel on;
- ``BIGDL_KERNELS=0`` / ``off`` / ``false`` / ``none`` / empty — every
  kernel off;
- ``BIGDL_KERNELS=flash,decode`` — a comma subset of ``flash`` /
  ``decode`` / ``int8``; an unknown name raises.

The default is **flash + decode + int8**, every kernel the port has
(K1 and K2 for flash, K3 and K4 for decode, K5 for int8) — the JAX
package's default on its chip is decode + int8. The JAX package leaves
flash opt-in on a TPU on the strength of TPU measurements; those do not
carry over to the card, and ``chip_smoke.py`` records K1 against the
einsum path on the H100 for a later revisit.

The JAX config's ``interpret`` flag has no meaning here: a kernel's
wrapper runs its plain PyTorch version for tensors on the CPU and
launches the kernel for CUDA tensors, whatever the config says.

The active config is read at each call (PyTorch runs eagerly; there is
no trace to bake it into).
"""
from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

__all__ = ["KernelConfig", "configure", "enabled", "get_config", "use"]

#: the ops a config can enable, in the order the env parser accepts
_OPS = ("flash", "decode", "int8")

#: the flash working-set budget when neither the config nor
#: ``BIGDL_VMEM_BUDGET_MB`` sets one (the JAX package's default, kept so
#: both packages route the same shapes to K1 and K2)
_DEFAULT_BUDGET_MB = 12


@dataclass(frozen=True)
class KernelConfig:
    """Which kernels the dispatch layer may select.

    ``flash_attention`` — the flash-attention training kernels (the
    full-row K1, and the blockwise K2 past the budget);
    ``decode_attention`` — the ragged and paged decode kernels (K3,
    K4); ``int8_matmul`` — the fused dequant int8 GEMM (K5). ``block_q`` /
    ``block_k`` are the preferred tiles of the plain versions (shrunk to
    a divisor of the dimension) and the unit of the working-set estimate
    that routes between K1 and K2. ``vmem_budget_mb`` is that budget in
    MiB (None: ``BIGDL_VMEM_BUDGET_MB``, else 12). ``long_context``
    routes shapes past the budget to the blockwise kernel (K2) instead
    of declining to the einsum path."""

    flash_attention: bool = False
    decode_attention: bool = False
    int8_matmul: bool = False
    block_q: int = 128
    block_k: int = 128
    vmem_budget_mb: Optional[int] = None
    long_context: bool = True

    @classmethod
    def all_on(cls, **kw) -> "KernelConfig":
        """Every kernel enabled (``BIGDL_KERNELS=1``)."""
        return cls(flash_attention=True, decode_attention=True,
                   int8_matmul=True, **kw)

    @classmethod
    def off(cls) -> "KernelConfig":
        """Every kernel disabled: the einsum path everywhere."""
        return cls()

    @classmethod
    def ported(cls, **kw) -> "KernelConfig":
        """The kernels the port has — flash + decode + int8, the
        default."""
        return cls(flash_attention=True, decode_attention=True,
                   int8_matmul=True, **kw)

    @classmethod
    def from_env(cls, value: str) -> "KernelConfig":
        """Parse a ``BIGDL_KERNELS`` value (module docstring has the
        grammar); unknown op names raise."""
        v = value.strip().lower()
        if v in ("1", "on", "all", "true"):
            return cls.all_on()
        if v in ("0", "off", "false", "none", ""):
            return cls.off()
        ops = {p.strip() for p in v.split(",") if p.strip()}
        unknown = ops - set(_OPS)
        if unknown:
            raise ValueError(
                f"BIGDL_KERNELS={value!r}: unknown kernel(s) "
                f"{sorted(unknown)} (choose from {list(_OPS)}, "
                "or 1/on/all, 0/off)")
        return cls(flash_attention="flash" in ops,
                   decode_attention="decode" in ops,
                   int8_matmul="int8" in ops)

    def resolve_vmem_budget(self) -> int:
        """The flash working-set budget in BYTES: an explicit
        ``vmem_budget_mb`` wins, else ``BIGDL_VMEM_BUDGET_MB``, else
        12 MiB."""
        mb = self.vmem_budget_mb
        if mb is None:
            env = os.environ.get("BIGDL_VMEM_BUDGET_MB")
            if env is not None:
                try:
                    mb = int(env)
                except ValueError:
                    raise ValueError(
                        f"BIGDL_VMEM_BUDGET_MB={env!r} is not an "
                        f"integer MiB count") from None
        if mb is None:
            mb = _DEFAULT_BUDGET_MB
        if mb <= 0:
            raise ValueError(
                f"flash working-set budget must be positive, got {mb} MiB")
        return mb * 1024 * 1024


_LOCK = threading.Lock()
_CONFIG: Optional[KernelConfig] = None  # None = resolve default lazily


def _default() -> KernelConfig:
    env = os.environ.get("BIGDL_KERNELS")
    if env is not None:
        return KernelConfig.from_env(env)
    return KernelConfig.ported()


def get_config() -> KernelConfig:
    """The active :class:`KernelConfig` (resolving the env default on
    first use)."""
    global _CONFIG
    with _LOCK:
        if _CONFIG is None:
            _CONFIG = _default()
        return _CONFIG


def configure(config: Optional[KernelConfig]) -> None:
    """Install ``config`` as the active policy; ``None`` restores the
    env default (re-resolved lazily)."""
    global _CONFIG
    with _LOCK:
        _CONFIG = config


@contextlib.contextmanager
def use(config: KernelConfig) -> Iterator[KernelConfig]:
    """Scoped :func:`configure`: the previous policy is restored on
    exit."""
    global _CONFIG
    with _LOCK:
        prev = _CONFIG
        _CONFIG = config
    try:
        yield config
    finally:
        with _LOCK:
            _CONFIG = prev


def enabled(op: str) -> bool:
    """Whether kernel ``op`` (``flash`` | ``decode`` | ``int8``) is
    enabled under the active config."""
    cfg = get_config()
    try:
        return {"flash": cfg.flash_attention,
                "decode": cfg.decode_attention,
                "int8": cfg.int8_matmul}[op]
    except KeyError:
        raise ValueError(f"unknown kernel op {op!r} "
                         f"(choose from {list(_OPS)})") from None
