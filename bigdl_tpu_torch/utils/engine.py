"""Device, dtype and process-group policy (counterpart of
``bigdl_tpu.utils.engine``).

The dtype knobs are the JAX package's ``Engine.set_default_dtype`` /
``set_compute_dtype``: the pre-policy configuration surface, which
``PrecisionPolicy.from_engine()`` reads. ``default_dtype()`` is the
dtype new parameters, caches and staged learning rates are made in.

The JAX package lets ``jax.devices()`` pick the platform; the port
makes the choice explicit instead. ``resolve_device(None)`` is the
card, and a missing card is an error, never a silent run on the CPU:
a caller who wants the CPU asks for it.

Distribution is one process per rank. :func:`init_distributed` starts
the process group from ``MASTER_ADDR`` / ``MASTER_PORT`` /
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` (what
``bigdl_tpu_torch.tools.launch`` gives each worker) or from an explicit
``init_method`` (a ``file://`` store in the tests), picks the backend by
:func:`choose_backend` (NCCL when CUDA is present and the node's ranks
fit its cards one each, else gloo: the CPU, and several ranks sharing
one card, which NCCL refuses as a duplicate GPU) and builds the default
mesh, one ``data`` axis over every rank (:func:`mesh`, the JAX
package's ``Engine.mesh()``). A rank's card is
``cuda:{LOCAL_RANK % device_count}`` (:func:`rank_device`).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import torch

__all__ = ["choose_backend", "compute_dtype", "core_number",
           "default_dtype", "full_float32", "init", "init_distributed",
           "is_initialized", "local_rank", "mesh", "model_device",
           "node_number", "rank_device", "reset", "resolve_device",
           "set_compute_dtype", "set_default_dtype", "set_mesh",
           "shutdown", "to_torch_dtype"]

#: parameter dtype of every module the port builds, and the activation
#: and matmul dtype (the JAX package's ``Engine`` defaults, float32)
_DTYPES = {"default": torch.float32, "compute": torch.float32}


def to_torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, ``"float16"``, ``"float32"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or getattr(dtype, "__name__", None) \
        or str(dtype)
    got = getattr(torch, str(name).split(".")[-1], None)
    if not isinstance(got, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return got


def set_default_dtype(dtype) -> None:
    """Parameter dtype of the modules built from now on (BigDL's
    Float/Double TensorNumeric choice; the JAX package's
    ``Engine.set_default_dtype``)."""
    _DTYPES["default"] = to_torch_dtype(dtype)


def default_dtype() -> torch.dtype:
    """The dtype new parameters and caches are created in."""
    return _DTYPES["default"]


def set_compute_dtype(dtype) -> None:
    """Activation and matmul dtype that ``PrecisionPolicy.from_engine()``
    reports (the JAX package's ``Engine.set_compute_dtype``)."""
    _DTYPES["compute"] = to_torch_dtype(dtype)


def compute_dtype() -> torch.dtype:
    return _DTYPES["compute"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def full_float32() -> None:
    """Run float32 matrix products and convolutions on the card in full
    float32. PyTorch's cuDNN default (``torch.backends.cudnn.allow_tf32
    = True``) runs every float32 convolution in TF32 on Hopper, about
    three decimal digits; the port's float32 models are references (the
    accuracy gate's float model among them), so the convolution layers
    call this before their first run on the card. It switches TF32 off
    for the process and never back on."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def model_device(model: torch.nn.Module) -> torch.device:
    """Where ``model``'s first parameter (or buffer) lives; the CPU for
    a model with neither."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    return torch.device("cpu")


# -- distribution ----------------------------------------------------------
#: the default mesh and the topology :func:`init` read; the process group
#: itself lives in ``torch.distributed``
_TOPO = {"mesh": None, "node_number": 1, "core_number": 1}

#: seconds a collective may wait before its process group gives up (a
#: rank that never reaches a collective fails the gang instead of
#: hanging it)
DEFAULT_TIMEOUT_S = 300.0


def local_rank() -> int:
    """This process's rank on its node (``LOCAL_RANK``, 0 when unset)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", 1)))


def choose_backend(local_world_size: Optional[int] = None) -> str:
    """The process-group backend for this node: ``"nccl"`` when CUDA is
    present and the node's ranks (``LOCAL_WORLD_SIZE``) fit its cards
    one each, ``"gloo"`` otherwise (the CPU, or several ranks sharing a
    card, which NCCL refuses with "Duplicate GPU detected"). The rule is
    fixed: nothing is tried and then retried another way."""
    lws = local_world_size if local_world_size is not None \
        else _local_world_size()
    if torch.cuda.is_available() and 0 < lws <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device this rank runs on: ``device`` when given as ``"cpu"``
    or with an index, else the card ``cuda:{LOCAL_RANK % device_count}``
    (raising without one, as :func:`resolve_device` does)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     mesh_axes: Sequence[str] = ("data",),
                     mesh_shape: Optional[Sequence[int]] = None):
    """Start this rank's process group (once a process), then
    :func:`init` the default mesh; returns the mesh.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``
    (1 and 0 when unset), ``init_method`` to ``env://`` (``MASTER_ADDR``
    and ``MASTER_PORT``), ``backend`` to :func:`choose_backend`. Every
    group gets ``timeout_s``. Under NCCL the rank's card becomes the
    current device first."""
    import torch.distributed as dist

    if not dist.is_initialized():
        world_size = int(os.environ.get("WORLD_SIZE", 1)) \
            if world_size is None else int(world_size)
        rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
        backend = backend or choose_backend()
        if backend == "nccl":
            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    return init(mesh_axes=mesh_axes, mesh_shape=mesh_shape)


def init(node_number: Optional[int] = None,
         core_number: Optional[int] = None,
         mesh_axes: Sequence[str] = ("data",),
         mesh_shape: Optional[Sequence[int]] = None):
    """Read the topology and build the default mesh (the JAX package's
    ``Engine.init``): ``mesh_shape`` over ``mesh_axes``, by default every
    rank on the first axis. ``node_number`` / ``core_number`` are taken
    for the reference's signature; the topology comes from the process
    group (nodes = world / ranks a node, cores = ranks a node). Without
    a process group the world is this one process."""
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    per_node = max(1, min(_local_world_size(), world))
    _TOPO["node_number"] = max(1, world // per_node)
    _TOPO["core_number"] = per_node
    if mesh_shape is None:
        mesh_shape = [world] + [1] * (len(mesh_axes) - 1)
    _TOPO["mesh"] = make_mesh(list(mesh_shape), list(mesh_axes))
    return _TOPO["mesh"]


def is_initialized() -> bool:
    return _TOPO["mesh"] is not None


def mesh():
    """The default mesh (:func:`init` builds it on first use)."""
    if _TOPO["mesh"] is None:
        init()
    return _TOPO["mesh"]


def set_mesh(m) -> None:
    _TOPO["mesh"] = m


def node_number() -> int:
    """Node count (Engine.nodeNumber)."""
    return _TOPO["node_number"]


def core_number() -> int:
    """Ranks a node (Engine.coreNumber)."""
    return _TOPO["core_number"]


def reset() -> None:
    """Forget the default mesh (the process group stays, as the JAX
    package's ``jax.distributed`` does)."""
    _TOPO["mesh"] = None


def shutdown() -> None:
    """Forget the mesh and destroy the process group (a worker's last
    call)."""
    import torch.distributed as dist

    reset()
    if dist.is_initialized():
        dist.destroy_process_group()
