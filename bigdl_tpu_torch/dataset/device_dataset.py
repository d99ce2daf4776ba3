"""The decoded image cache on the card, augmented there (counterpart of
``bigdl_tpu.dataset.device_dataset``).

:class:`DeviceCachedArrayDataSet` holds a dataset's decoded images as
one uint8 ``[N, C, H+2p, W+2p]`` tensor on the card (padded once, at
construction) and its labels as float32; a training batch is gathered,
cropped, flipped and normalized there, so a step copies nothing from
the host. Batches visit the samples epoch by epoch in the JAX package's
order: position ``pos`` of epoch ``e`` holds sample
``feistel_e(pos)``, a four-round Feistel network over the smallest
even-bit-width domain covering N, cycle-walked back into ``[0, N)``,
whose round keys are ``jax.random.bits(fold_in(PRNGKey(seed), e), (4,),
uint32)`` — threefry2x32 ported here as integer tensor arithmetic
(:func:`threefry2x32`, :func:`fold_in`, :func:`random_bits32`), bit for
bit. The cycle walk is a loop whose length depends on the data, which
a captured CUDA graph cannot hold, so an epoch's whole visit order is
built once, outside any graph, at the epoch's first use
(:meth:`DeviceCachedArrayDataSet.ready_epochs`) into one of two rows of
a table on the card (epoch ``e`` in row ``e % 2``); a step gathers its
indices from the table (:meth:`~DeviceCachedArrayDataSet.cursor_indices`,
a cursor tensor on the card), so a graph replays it. A walk longer than
``walk_limit`` rounds raises: nothing is truncated.

Crop offsets and flips are drawn from a ``torch.Generator`` the caller
passes (the Optimizer passes its step's generator, which a window's
graph registers), not from the JAX package's key stream:
:meth:`~DeviceCachedArrayDataSet.assemble` takes explicit draws, so the
same draws give the JAX package's batch bit for bit.

:class:`ShardRotator` keeps two persistent slots on the card: the
resident one feeds the steps while the next shard is copied into the
other in pieces of ``chunk_bytes`` (:func:`~bigdl_tpu_torch.utils.
transfer.probe_device_put_chunk` by default) through a ring of two
pinned host buffers on a side stream; ``rotate()`` swaps the slots.
The slots alternate and never move, so a graph captured on a slot
stays right whenever that slot is resident. :class:`RotatingDeviceDataSet`
hands it to the Optimizer.

Every class here defaults to the card and raises without CUDA unless
given ``device="cpu"``. A ``sharding=`` and a run of more than one
process raise: the mesh is ROADMAP queue 1, item 11.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["DeviceCachedArrayDataSet", "RotatingDeviceDataSet",
           "ShardRotator", "fold_in", "prng_key", "random_bits32",
           "threefry2x32"]

_M32 = 0xFFFFFFFF
#: the cycle walk's bound in rounds; the longest walk of a permutation
#: of n positions over a domain under 4n is a few dozen rounds
WALK_LIMIT = 1024


# ------------------------------------------------------------ threefry

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds, JAX's ``threefry2x32_p``) on
    int64 tensors (or Python ints) holding uint32 values; returns the
    two output words."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the seed as
    int32, so the key is ``[0, seed mod 2**32]`` (int64 tensor [2])."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    ``(0, data)`` under ``key``; ``data`` an int or an int64 tensor."""
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(key[0]),
                          torch.as_tensor(data, dtype=torch.int64,
                                          device=key.device) & _M32)
    return torch.stack([y0, y1])


def random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` under
    ``jax_threefry_partitionable`` (JAX 0.5 on): element ``i`` is the
    xor of threefry's two words for the counter pair ``(0, i)``."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(count), count)
    return y0 ^ y1


# ------------------------------------------------------------- feistel

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for ``a`` < 2**32 in int64 without overflow:
    ``c`` in 16-bit halves, every partial product under 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    x = _mul32((x + k) & _M32, 0x9E3779B1)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x85EBCA6B)
    return x ^ (x >> 13)


def _feistel(x: torch.Tensor, keys: torch.Tensor, half: int
             ) -> torch.Tensor:
    mask = (1 << half) - 1
    hi, lo = (x >> half) & mask, x & mask
    for i in range(4):
        hi, lo = lo, hi ^ (_mix(lo, keys[i]) & mask)
    return (hi << half) | lo


def _check_single_process(sharding) -> None:
    if sharding is not None:
        raise NotImplementedError(
            "sharding=: the device cache over a mesh is not ported yet "
            "(ROADMAP queue 1, item 11)")
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the device cache in a run of more than one process is not "
            "ported yet (ROADMAP queue 1, item 11)")


def _card(device) -> torch.device:
    """``device`` checked and with its index (``cuda`` is the current
    card)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the device cache lives on the "
                "card; pass device='cpu' to hold it in host memory")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _as_uint8(images: np.ndarray) -> np.ndarray:
    """The JAX package's conversion: floats in [0, 1] scaled by 255,
    anything else cast."""
    if images.dtype != np.uint8:
        scaled = images * 255 if images.max() <= 1.0 else images
        images = scaled.astype(np.uint8)
    return images


class _RowStager:
    """Copies host rows into device tensors a piece at a time: on the
    card through a ring of two pinned buffers on a side stream (a
    buffer is written again only after the event of the copy out of it
    has completed), on the CPU directly. ``rows`` bounds a piece."""

    def __init__(self, device: torch.device, rows: int,
                 planes: Sequence[Tuple[tuple, torch.dtype]]):
        self.device = device
        self.rows = rows
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.ring = [[torch.empty((rows,) + tuple(shape), dtype=dt,
                                      pin_memory=True)
                          for shape, dt in planes] for _ in range(2)]
            self.events: List[Optional[torch.cuda.Event]] = [None, None]
            self.turn = 0

    def after_current(self) -> None:
        """Later copies wait for the work the current stream holds now
        (the steps that still read a slot about to be overwritten)."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def put(self, dests: Sequence[torch.Tensor], off: int,
            pieces: Sequence[np.ndarray]) -> None:
        k = len(pieces[0])
        if k > self.rows:
            raise ValueError(f"a piece of {k} rows exceeds the stager's "
                             f"{self.rows}")
        if not self.cuda:
            for d, p in zip(dests, pieces):
                d[off:off + k].copy_(torch.from_numpy(
                    np.ascontiguousarray(p)))
            return
        i = self.turn
        self.turn ^= 1
        if self.events[i] is not None:
            self.events[i].synchronize()
        bufs = self.ring[i]
        for b, p in zip(bufs, pieces):
            b[:k].numpy()[...] = p
        with torch.cuda.stream(self.stream):
            for d, b in zip(dests, bufs):
                d[off:off + k].copy_(b[:k], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event

    def finish(self) -> None:
        """The current stream waits for every copy issued so far."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def synchronize(self) -> None:
        """The host waits for every copy issued so far."""
        if self.cuda:
            for e in self.events:
                if e is not None:
                    e.synchronize()


class _EpochTable:
    """Two epochs' visit orders on the card: epoch ``e`` in row
    ``e % 2``; shared by every slot of one geometry."""

    def __init__(self, n: int, device: torch.device):
        self.rows = torch.zeros((2, n), dtype=torch.int64, device=device)
        self.epochs: List[Optional[int]] = [None, None]


class DeviceCachedArrayDataSet:
    """uint8 ``[N, C, H, W]`` images and their labels held on ``device``
    (the card by default), with the JAX package's augmentation there:
    random pad-crop, horizontal flip and per-channel normalize
    (dataset/image's BGRImgCropper, HFlip and BGRImgNormalizer).

    ``images`` that are not uint8 are scaled by 255 when their maximum
    is at most 1 and cast; ``pad`` pads them once; ``crop`` (default the
    image) is the crop; ``mean`` / ``std`` normalize per channel. With
    ``put_chunk_bytes`` the cache is copied in pieces of that size into
    a destination allocated once. ``walk_limit`` bounds the cycle walk
    (:data:`WALK_LIMIT`); a walk past it raises."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, *, crop: Optional[Tuple[int, int]] = None,
                 pad: int = 0, flip: bool = True,
                 mean: Sequence[float] = (0.0, 0.0, 0.0),
                 std: Sequence[float] = (1.0, 1.0, 1.0),
                 sharding=None, shuffle_seed: int = 0,
                 put_chunk_bytes: Optional[int] = None,
                 device="cuda"):
        _check_single_process(sharding)
        device = _card(device)
        images = _as_uint8(np.ascontiguousarray(images))
        n, c, h, w = images.shape
        if len(labels) < n:
            raise ValueError("labels shorter than images")
        ch, cw = crop or (h, w)
        if ch > h + 2 * pad or cw > w + 2 * pad:
            raise ValueError("crop larger than padded source")
        self.n, self.c = n, c
        self.h, self.w = h, w
        self.crop_h, self.crop_w = ch, cw
        self.pad = pad
        self.flip = flip
        self.batch_size = batch_size
        self.device = device
        self.shuffle_seed = shuffle_seed
        self.walk_limit = WALK_LIMIT
        self._mean = torch.as_tensor(mean, dtype=torch.float32,
                                     device=device).reshape(1, -1, 1, 1)
        self._std = torch.as_tensor(std, dtype=torch.float32,
                                    device=device).reshape(1, -1, 1, 1)
        if pad:                      # once: crops need no bounds logic
            images = np.pad(images, ((0, 0), (0, 0), (pad, pad),
                                     (pad, pad)))
        self.images = self._put(images, put_chunk_bytes)
        # copies, also on the CPU: a rotator writes later shards into
        # these tensors, never into the caller's arrays
        self.labels = torch.from_numpy(
            np.ascontiguousarray(labels, np.float32)).to(device, copy=True)
        self._table = _EpochTable(n, device)
        self._perm_key = prng_key(shuffle_seed, device)
        self._arange = {}

    def _put(self, images: np.ndarray, chunk_bytes: Optional[int]):
        if chunk_bytes is None or images.nbytes <= chunk_bytes:
            return torch.from_numpy(images).to(self.device, copy=True)
        rows = max(1, chunk_bytes // max(1, images[0].nbytes))
        dest = torch.empty(images.shape, dtype=torch.uint8,
                           device=self.device)
        stager = _RowStager(self.device, rows,
                            [(images.shape[1:], torch.uint8)])
        stager.after_current()
        for off in range(0, len(images), rows):
            stager.put([dest], off, [images[off:off + rows]])
        stager.finish()
        stager.synchronize()       # the pinned ring is freed with it
        return dest

    def size(self) -> int:
        return self.n

    def _iota(self, k: int) -> torch.Tensor:
        t = self._arange.get(k)
        if t is None:
            t = self._arange[k] = torch.arange(k, dtype=torch.int64,
                                               device=self.device)
        return t

    # ----------------------------------------------------- permutation
    def round_keys(self, epoch: int) -> torch.Tensor:
        """The Feistel round keys of ``epoch``: ``jax.random.bits(
        fold_in(PRNGKey(shuffle_seed), epoch), (4,), uint32)``."""
        return random_bits32(fold_in(self._perm_key, int(epoch)), 4)

    def _permute_in_epoch(self, pos: torch.Tensor, epoch: int
                          ) -> torch.Tensor:
        """Positions ``pos`` of ``epoch`` -> sample indices: the Feistel
        network, then the cycle walk back into ``[0, n)`` (a host read
        a round; more than ``walk_limit`` rounds raise)."""
        half = max(1, ((self.n - 1).bit_length() + 1) // 2)
        keys = self.round_keys(epoch)
        x = _feistel(pos.to(torch.int64), keys, half)
        rounds = 0
        while True:
            out = x >= self.n
            if not bool(out.any()):
                return x
            rounds += 1
            if rounds > self.walk_limit:
                raise RuntimeError(
                    f"cycle walk of epoch {epoch} passed walk_limit="
                    f"{self.walk_limit} rounds (n={self.n})")
            x = torch.where(out, _feistel(x, keys, half), x)

    def sample_indices(self, step=None, *, epoch=None, pos=None
                       ) -> torch.Tensor:
        """The batch's sample indices (int64 on the device), computed
        directly: from ``step`` (the global iteration, 0-based) or the
        cursor ``(epoch, pos)`` with ``pos`` in ``[0, n)``. The stream is
        the concatenation of the epochs' permutations; a batch that
        straddles an epoch maps each element through its own epoch's,
        and a batch larger than n walks one permutation modulo n."""
        b = self.batch_size
        if step is None and (epoch is None or pos is None):
            raise ValueError(
                "pass step, or BOTH epoch and pos (the decomposed cursor)")
        if step is not None:
            epoch, pos = divmod(int(step) * b, self.n)
        epoch, pos = int(epoch), int(pos)
        offs = pos + self._iota(b)
        pp = offs % self.n
        if b > self.n:
            return self._permute_in_epoch(pp, epoch)
        return torch.where(offs // self.n == 0,
                           self._permute_in_epoch(pp, epoch),
                           self._permute_in_epoch(pp, epoch + 1))

    def ready_epochs(self, epoch: int) -> None:
        """Build the visit orders a step whose cursor starts in
        ``epoch`` reads (``epoch`` and, for a batch that may straddle,
        ``epoch + 1``) into the table, where a row does not hold them
        already. Host reads; call it outside a graph capture."""
        t = self._table
        need = (epoch,) if self.batch_size > self.n else (epoch, epoch + 1)
        for e in need:
            if t.epochs[e % 2] != e:
                t.rows[e % 2].copy_(self._permute_in_epoch(
                    self._iota(self.n), e))
                t.epochs[e % 2] = e

    def cursor_indices(self, cursor: torch.Tensor) -> torch.Tensor:
        """The batch's indices from an int64 cursor tensor ``[epoch,
        pos]`` on the device, read from the table: no host read, so a
        CUDA graph replays it. :meth:`ready_epochs` must have built the
        cursor's epochs."""
        b, n = self.batch_size, self.n
        offs = cursor[1] + self._iota(b)
        if b > n:
            row = cursor[0] % 2
        else:
            row = (cursor[0] + offs // n) % 2
        return self._table.rows.view(-1)[row * n + offs % n]

    # ------------------------------------------------------- batches
    def draws(self, generator: Optional[torch.Generator]):
        """This batch's crop offsets and flips from ``generator``:
        ``(oys, oxs, flips or None)``."""
        b, dev = self.batch_size, self.device
        max_oy = self.h + 2 * self.pad - self.crop_h + 1
        max_ox = self.w + 2 * self.pad - self.crop_w + 1
        oys = torch.randint(0, max_oy, (b,), generator=generator,
                            device=dev)
        oxs = torch.randint(0, max_ox, (b,), generator=generator,
                            device=dev)
        flips = (torch.rand((b,), generator=generator, device=dev) < 0.5
                 if self.flip else None)
        return oys, oxs, flips

    def assemble(self, images: torch.Tensor, labels: torch.Tensor,
                 idx: torch.Tensor, oys: torch.Tensor, oxs: torch.Tensor,
                 flips: Optional[torch.Tensor] = None):
        """The batch for explicit draws: rows ``idx`` of ``images``,
        cropped at ``(oys, oxs)``, flipped where ``flips``, as float32
        ``(x - mean) / std`` (a contiguous NCHW tensor), and their
        labels. One gather makes the uint8 crops."""
        ch, cw = self.crop_h, self.crop_w
        rows = oys.to(torch.int64)[:, None] + self._iota(ch)
        step = self._iota(cw)
        cols = oxs.to(torch.int64)[:, None] + step
        if flips is not None:
            cols = torch.where(flips[:, None], cols.flip(1), cols)
        idx = idx.to(torch.int64)
        crops = images[idx[:, None, None, None],
                       self._iota(self.c)[None, :, None, None],
                       rows[:, None, :, None], cols[:, None, None, :]]
        x = (crops.to(torch.float32) - self._mean) / self._std
        return x.contiguous(), labels[idx]

    def batch_fn(self, generator=None, step=None, *, epoch=None,
                 pos=None, cursor=None):
        """One augmented training batch from the resident cache: see
        :meth:`batch_fn_on`."""
        return self.batch_fn_on(self.images, self.labels, generator, step,
                                epoch=epoch, pos=pos, cursor=cursor)

    def batch_fn_on(self, images, labels, generator=None, step=None, *,
                    epoch=None, pos=None, cursor=None):
        """One augmented training batch from ``images`` / ``labels``
        (this dataset's geometry: a rotating slot). The indices come from
        ``cursor`` (an int64 ``[epoch, pos]`` tensor on the device, read
        from the table: :meth:`cursor_indices`), or ``step`` or
        ``(epoch, pos)`` (:meth:`sample_indices`), or, with none of
        them, are drawn i.i.d. with replacement; then the crop offsets
        and flips are drawn from ``generator``."""
        if (epoch is None) != (pos is None):
            raise ValueError(
                "pass epoch and pos together (the decomposed cursor), "
                "or step alone")
        if cursor is not None:
            idx = self.cursor_indices(cursor)
        elif step is None and epoch is None:
            idx = torch.randint(0, self.n, (self.batch_size,),
                                generator=generator, device=self.device)
        else:
            idx = self.sample_indices(step, epoch=epoch, pos=pos)
        return self.assemble(images, labels, idx, *self.draws(generator))

    def _from_device(self, images, labels) -> "DeviceCachedArrayDataSet":
        """This geometry around other slot tensors (the table and the
        constants shared)."""
        clone = object.__new__(DeviceCachedArrayDataSet)
        clone.__dict__.update(self.__dict__)
        clone.images, clone.labels = images, labels
        return clone

    def eval_batch_fn(self, start: int):
        """The deterministic centre-crop batch at ``start``."""
        return self.eval_batch_fn_on(self.images, self.labels, start)

    def eval_batch_fn_on(self, images, labels, start: int):
        """:meth:`eval_batch_fn` on ``images`` / ``labels``: rows
        ``start, start + 1, ...`` modulo n, centre-cropped, normalized."""
        b = self.batch_size
        idx = (int(start) + self._iota(b)) % self.n
        oy = (self.h + 2 * self.pad - self.crop_h) // 2
        ox = (self.w + 2 * self.pad - self.crop_w) // 2
        crops = images[idx, :, oy:oy + self.crop_h, ox:ox + self.crop_w]
        x = (crops.to(torch.float32) - self._mean) / self._std
        return x.contiguous(), labels[idx]


class ShardRotator:
    """Two shard slots on the card: train on the resident one while the
    next shard is copied into the other in pieces of at most
    ``chunk_bytes`` (:meth:`pump`), then swap (:meth:`rotate`).

    ``provider(i)`` returns shard ``i`` as ``(uint8 images [M, C, H, W],
    labels [M])``, M the same for every shard. Shards are visited in one
    fixed cycle, shuffled once from ``seed`` with numpy (the JAX
    package's order); with the in-shard Feistel permutation, a shard
    that runs one shard-epoch before rotating visits each sample once a
    data epoch. The slots are allocated once and alternate, so staging
    peaks at one slot plus the pinned ring; a copy into the slot that
    was resident waits for the work queued on it before the rotation.
    ``pumped_bytes`` and ``rotations`` count what it did."""

    def __init__(self, provider: Callable, n_shards: int, batch_size: int,
                 *, crop=None, pad: int = 0, flip: bool = True,
                 mean: Sequence[float] = (0.0, 0.0, 0.0),
                 std: Sequence[float] = (1.0, 1.0, 1.0),
                 chunk_bytes: Optional[int] = None,
                 shuffle_shards: bool = True, seed: int = 0,
                 sharding=None, device="cuda"):
        if n_shards < 2:
            raise ValueError("rotation needs at least 2 shards")
        _check_single_process(sharding)
        device = _card(device)
        self.provider = provider
        self.n_shards = n_shards
        self.pad = pad
        self.device = device
        self._rng = np.random.RandomState(seed)
        self.order = (self._rng.permutation(n_shards)
                      if shuffle_shards else np.arange(n_shards))
        self._cycle_pos = 0
        imgs0, lbls0 = provider(int(self.order[0]))
        self.template = DeviceCachedArrayDataSet(
            imgs0, lbls0, batch_size, crop=crop, pad=pad, flip=flip,
            mean=mean, std=std, shuffle_seed=seed, device=device)
        self.shard_size = self.template.n
        if chunk_bytes is None:
            from bigdl_tpu_torch.utils.transfer import probe_device_put_chunk
            chunk_bytes = probe_device_put_chunk(device=device)
        self.chunk_bytes = int(chunk_bytes)
        imgs = self.template.images
        self._slots = [(imgs, self.template.labels),
                       (torch.empty_like(imgs),
                        torch.empty((self.shard_size,), dtype=torch.float32,
                                    device=device))]
        self._rows = max(1, self.chunk_bytes // imgs[0].numel())
        self._stager = _RowStager(device, self._rows,
                                  [(tuple(imgs.shape[1:]), torch.uint8),
                                   ((), torch.float32)])
        self.pumped_bytes = 0
        self.rotations = 0
        self._staging = None   # [images, labels, slot, rows copied]
        self._begin_stage()

    @property
    def images(self) -> torch.Tensor:
        return self.template.images

    @property
    def labels(self) -> torch.Tensor:
        return self.template.labels

    @property
    def resident_slot(self) -> int:
        """Which of the two slots feeds the steps (0 or 1)."""
        return 0 if self.images is self._slots[0][0] else 1

    def _next_shard_index(self) -> int:
        nxt = self._cycle_pos + 1
        if nxt >= self.n_shards:
            # the cycle wraps: the same order again, from its head
            return int(self.order[0])
        return int(self.order[nxt])

    def _begin_stage(self) -> None:
        imgs, lbls = self.provider(self._next_shard_index())
        if len(imgs) != self.shard_size:
            raise ValueError(
                f"shard size mismatch: {len(imgs)} vs {self.shard_size} "
                "rows (all shards must be equal; pad or drop the "
                "remainder)")
        if len(lbls) != len(imgs):
            raise ValueError(
                f"provider returned {len(lbls)} labels for {len(imgs)} "
                "images — rows must pair 1:1")
        imgs = _as_uint8(np.asarray(imgs))
        if self.pad:
            imgs = np.pad(imgs, ((0, 0), (0, 0), (self.pad, self.pad),
                                 (self.pad, self.pad)))
        if imgs.shape[1:] != tuple(self.images.shape[1:]):
            raise ValueError(f"shard image shape {imgs.shape[1:]} differs "
                             f"from the first shard's "
                             f"{tuple(self.images.shape[1:])}")
        self._staging = [imgs, np.ascontiguousarray(lbls, np.float32),
                         1 - self.resident_slot, 0]
        # copies into the old slot wait for the steps already queued on it
        self._stager.after_current()

    @property
    def staged(self) -> bool:
        return self._staging is not None and \
            self._staging[3] >= len(self._staging[0])

    def pump(self) -> bool:
        """Copy at most ``chunk_bytes`` of the next shard into its slot;
        returns :attr:`staged`."""
        if self.staged:
            return True
        imgs, lbls, slot, off = self._staging
        k = min(self._rows, len(imgs) - off)
        self._stager.put(self._slots[slot], off,
                         [imgs[off:off + k], lbls[off:off + k]])
        self._staging[3] = off + k
        self.pumped_bytes += imgs[off:off + k].nbytes + 4 * k
        return self.staged

    def rotate(self) -> None:
        """Swap the staged shard in as the resident slot and begin
        staging the one after it."""
        if not self.staged:
            raise RuntimeError(
                "rotate() before staging finished — pump() until staged")
        slot = self._staging[2]
        self._stager.finish()      # the steps after this read the copies
        self.template = self.template._from_device(*self._slots[slot])
        self._cycle_pos = (self._cycle_pos + 1) % self.n_shards
        self.rotations += 1
        self._begin_stage()


class RotatingDeviceDataSet:
    """The Optimizer's feed over a :class:`ShardRotator`: datasets larger
    than the card's memory at device-cached rates. The Optimizer reads
    the resident slot at every step (a window's graph is captured once
    a slot) and calls :meth:`after_step` after each step's loss fetch,
    which copies one piece of the next shard and rotates at shard
    boundaries. ``size()`` spans every shard, so epoch triggers and
    schedules see data epochs. A batch that straddles a shard boundary
    draws its tail from the resident shard's next visit order (shard
    sizes should be multiples of the batch size)."""

    rotating = True
    continuous_stream = True

    def __init__(self, rotator: ShardRotator):
        self.rot = rotator
        self._consumed_shards = 0

    @property
    def template(self) -> DeviceCachedArrayDataSet:
        return self.rot.template

    @property
    def images(self) -> torch.Tensor:
        return self.rot.images

    @property
    def labels(self) -> torch.Tensor:
        return self.rot.labels

    @property
    def batch_size(self) -> int:
        return self.rot.template.batch_size

    @property
    def device(self) -> torch.device:
        return self.rot.device

    def size(self) -> int:
        return self.rot.shard_size * self.rot.n_shards

    def shard_cursor(self, neval: int):
        """``(visit, pos in shard)`` of iteration ``neval`` (1-based, the
        driver's): ``visit`` keys the in-shard permutation, so every
        visit of a shard reshuffles it."""
        gpos = (neval - 1) * self.batch_size
        return divmod(gpos, self.rot.shard_size)

    def after_step(self, neval: int) -> None:
        """After iteration ``neval``'s loss fetch: rotate for every shard
        boundary the sample stream crossed (staging the rest first),
        then copy one piece of the next shard."""
        done_shards = (neval * self.batch_size) // self.rot.shard_size
        while self._consumed_shards < done_shards:
            while not self.rot.staged:
                self.rot.pump()
            self.rot.rotate()
            self._consumed_shards += 1
        self.rot.pump()

    def shuffle(self) -> None:
        pass
