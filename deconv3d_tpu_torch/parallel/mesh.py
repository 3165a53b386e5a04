"""Device meshes and the collectives of the sharded paths, across ranks.

Counterpart of ``deconv3d_tpu/parallel/mesh.py``.  The JAX package drives
every device of a ``jax.sharding.Mesh`` through ``shard_map`` and lets XLA
move the data, within a process and across processes alike.  A
:class:`Mesh` here is an array of ``torch.device`` slots with named axes,
1-D or 2-D, and the rank of the process that owns each slot
(``torch.distributed``; ``parallel/multihost.py`` builds a mesh over every
rank's devices).  A sharded tensor is the list of the slots' tensors, in
slot order; the entries of slots that another rank owns are ``None``.

The collectives below take the slots' owners as ``ranks`` (None: every
slot in this process).  Between two slots of one rank they are copies
(device to device; on a CUDA device never through the host); between two
ranks they are point-to-point messages (``dist.batch_isend_irecv``).  Under
the ``gloo`` backend, which sends host tensors only, a CUDA tensor goes
through a pinned host buffer on both sides; a rank on ``nccl`` sends CUDA
tensors as they are.  Sums add the gathered parts in slot order on every
rank, so a sum across ranks is the one-process sum bit for bit.  Slots may
repeat a device: ``Mesh([cuda:0] * 2, ("sp",))`` runs two shards, and
their strip exchanges, on one card, and two ranks may share a card.
``all_to_all_ragged`` takes uneven chunks (the sharded direct solve's
frequency columns).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def process_rank() -> int:
    """This process's rank in the ``torch.distributed`` group (0 without
    one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index (a tensor's ``.device``
    always names one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Slots(list):
    """The slots of one mesh axis in slot order: their devices (the list
    itself) and the rank that owns each (``ranks``)."""

    def __init__(self, devices, ranks: Optional[Sequence[int]] = None):
        super().__init__(devices)
        self.ranks = (tuple([process_rank()] * len(self)) if ranks is None
                      else tuple(int(r) for r in ranks))
        if len(self.ranks) != len(self):
            raise ValueError(f"{len(self.ranks)} ranks for {len(self)} slots")

    def local(self) -> List[bool]:
        """Per slot: does this process own it?"""
        me = process_rank()
        return [r == me for r in self.ranks]


class Mesh:
    """A 1-D or 2-D array of ``torch.device`` slots with axis names.

    ``devices``: a (nested) sequence of devices or device strings whose
    nesting depth is ``len(axis_names)``.  ``ranks``: the owning rank of
    every slot, of the same nesting (default: this process for every slot,
    the single-controller mesh).  ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str] = ("sp",),
                 ranks=None):
        axis_names = tuple(axis_names)
        if not 1 <= len(axis_names) <= 2 or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(
                f"a mesh has one or two distinct axes, got {axis_names}")
        nested = np.empty(np.shape(np.array(devices, dtype=object)),
                          dtype=object)
        for idx in np.ndindex(nested.shape):
            nested[idx] = _device(np.array(devices, dtype=object)[idx])
        if nested.ndim != len(axis_names) or nested.size == 0:
            raise ValueError(
                f"devices of shape {nested.shape} do not match the axes "
                f"{axis_names}")
        if ranks is None:
            ranks = np.full(nested.shape, process_rank())
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.shape != nested.shape:
            raise ValueError(f"ranks of shape {ranks.shape} for devices of "
                             f"shape {nested.shape}")
        self.devices = nested
        self.ranks = ranks
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self, axis_name: str) -> List[Slots]:
        """The slots along ``axis_name``: one :class:`Slots` per index of
        the other axis (one for a 1-D mesh)."""
        if axis_name not in self.axis_names:
            raise ValueError(
                f"mesh has no {axis_name!r} axis (axes: {self.axis_names})")
        axis = self.axis_names.index(axis_name)
        arr = np.moveaxis(self.devices, axis, -1)
        ranks = np.moveaxis(self.ranks, axis, -1)
        return [Slots(row, r) for row, r in zip(
            arr.reshape(-1, arr.shape[-1]),
            ranks.reshape(-1, ranks.shape[-1]).tolist())]

    def __repr__(self) -> str:
        if (self.ranks == process_rank()).all():
            return f"Mesh({self.devices.tolist()!r}, {self.axis_names!r})"
        return (f"Mesh({self.devices.tolist()!r}, {self.axis_names!r}, "
                f"ranks={self.ranks.tolist()!r})")


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "chains") -> Mesh:
    """1-D mesh over the first ``n_devices`` CUDA devices (default: all).

    Raises when fewer exist (``jax.devices()[:k]`` silently gives a smaller
    mesh).  For several shards on one card, pass
    ``Mesh([torch.device("cuda:0")] * k, (axis_name,))``."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise ValueError(
            f"make_mesh({n_devices}) needs {max(n, 1)} CUDA device(s), "
            f"{have} present; for several shards on one device pass "
            "Mesh([device] * k, axis_names)")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis_name,))


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

def _one_process(ranks: Optional[Sequence[int]]) -> bool:
    """Are all the slots this process's (today's single-controller path)?"""
    return ranks is None or all(r == process_rank() for r in ranks)


def _p2p(sends, recvs) -> List[torch.Tensor]:
    """Point-to-point messages of this rank: ``sends`` (peer, tag, tensor),
    ``recvs`` (peer, tag, shape, dtype, device), both in an order every
    rank shares; returns the received tensors in ``recvs``' order.  Under
    ``gloo`` a CUDA tensor crosses through a pinned host buffer; under
    ``nccl`` a host tensor raises."""
    staged = dist.get_backend() == "gloo"
    ops, bufs = [], []
    for peer, tag, t in sends:
        if staged and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            t = buf
        elif not staged and not t.is_cuda:
            raise ValueError(f"the {dist.get_backend()} backend sends CUDA "
                             "tensors; this one is on the host")
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer, tag=tag))
    for peer, tag, shape, dtype, device in recvs:
        if staged and device.type == "cuda":
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            buf = torch.empty(shape, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        bufs.append(buf)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(r[4]) for b, r in zip(bufs, recvs)]


#: a message's shape header: ndim, then up to this many sizes
_MAX_DIMS = 8


def route(msgs, ranks: Sequence[int], shapes_known: bool = True):
    """Deliver messages between slots (across ranks: the transport of
    every collective here).  ``msgs``: (src, dst, tensor, like)
    in an order every rank shares, ``src`` a slot index, ``dst`` a slot
    index or ``('rank', r)`` (to rank r itself); ``tensor`` where this
    process owns ``src`` (else None), ``like`` = (shape, dtype, device)
    where it owns ``dst`` (else None; ``shape`` None when
    ``shapes_known`` is False: then every cross-rank message is preceded
    by a header of its shape).  Returns {(src, dst): tensor} of the
    messages this process receives, on ``like``'s device."""
    me = process_rank()
    n = len(ranks)

    def owner(x):
        return x[1] if isinstance(x, tuple) else ranks[x]

    def tag(src, dst):
        return src * (n + dist.get_world_size()) + (
            n + dst[1] if isinstance(dst, tuple) else dst)

    out, cross = {}, []
    for src, dst, t, like in msgs:
        if owner(src) == me and owner(dst) == me:
            out[src, dst] = t.to(like[2], copy=True)
        elif owner(src) == me or owner(dst) == me:
            cross.append((src, dst, t, like))
    if not shapes_known:
        heads = []
        for src, dst, t, _ in cross:
            if t is not None:
                h = torch.zeros(_MAX_DIMS + 1, dtype=torch.int64)
                h[0] = t.dim()
                h[1:1 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
                heads.append((owner(dst), tag(src, dst), h.to(t.device)))
        heads = iter(_p2p(heads, [
            (owner(src), tag(src, dst), (_MAX_DIMS + 1,), torch.int64,
             like[2]) for src, dst, t, like in cross if t is None]))
        sized = []
        for src, dst, t, like in cross:
            if t is None:
                h = next(heads).tolist()
                like = (tuple(h[1:1 + h[0]]), like[1], like[2])
            sized.append((src, dst, t, like))
        cross = sized
    got = _p2p(
        [(owner(dst), tag(src, dst), t) for src, dst, t, _ in cross
         if t is not None],
        [(owner(src), tag(src, dst), *like) for src, dst, t, like in cross
         if t is None])
    for (src, dst, _, _), t in zip([c for c in cross if c[2] is None], got):
        out[src, dst] = t
    return out


def _everyone(parts, ranks, device, shapes_known: bool):
    """Every slot's tensor on every rank of the axis: this process's own
    parts as they are, the others' received on ``device``."""
    me = process_rank()
    mine = local_parts(parts)[0]
    like = (mine.shape if shapes_known else None, mine.dtype, device)
    msgs = [(i, ("rank", r), t if ranks[i] == me else None,
             like if r == me else None)
            for i, t in enumerate(parts) for r in sorted(set(ranks))
            if r != ranks[i]]
    got = route(msgs, ranks, shapes_known)
    return [t if ranks[i] == me else got[i, ("rank", me)]
            for i, t in enumerate(parts)]


def local_parts(parts) -> List[torch.Tensor]:
    """The parts of a sharded tensor that this process holds."""
    return [t for t in parts if t is not None]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def split(x: torch.Tensor, devices: Sequence[torch.device],
          dim: int = 0) -> List[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal parts along ``dim``, part i on
    ``devices[i]`` (a copy of its own on every slot; None on the slots of
    other ranks when ``devices`` is a :class:`Slots`)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of size {x.shape[dim]} must be divisible by "
            f"the mesh size {n}")
    mine = devices.local() if isinstance(devices, Slots) else [True] * n
    return [part.to(dev, copy=True).contiguous() if m else None
            for part, dev, m in zip(torch.chunk(x, n, dim=dim), devices,
                                    mine)]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 0,
           ranks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The slots' tensors concatenated along ``dim`` on ``device``, on
    every rank of ``ranks``."""
    if not _one_process(ranks):
        parts = _everyone(parts, ranks, torch.device(device), False)
    return torch.cat([t.to(device) for t in parts], dim=dim)


def slot_sum(parts: Sequence[torch.Tensor],
             ranks: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The sum over the slots, summed in slot order on the first slot's
    device (across ranks: on this rank's first slot's device, every rank
    adding the same parts in the same order)."""
    if not _one_process(ranks):
        dev = next(t for t in parts if t is not None).device
        parts = _everyone(parts, ranks, dev, True)
        parts = [parts[0].to(dev)] + list(parts[1:])
    total = parts[0]
    for t in parts[1:]:
        total = total + t.to(total.device)
    return total


def barrier(devices: Sequence, ranks: Sequence[int]) -> None:
    """Return once every rank of ``ranks`` (the owners of the slots
    ``devices``) has called it: a :func:`slot_sum` of one zero per slot,
    so it waits on exactly the mesh's ranks."""
    me = process_rank()
    slot_sum([torch.zeros(1, device=d) if r == me else None
              for d, r in zip(devices, ranks)], ranks)


def psum(parts: Sequence[torch.Tensor],
         ranks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """:func:`slot_sum`, copied to every slot (JAX's ``psum``)."""
    total = slot_sum(parts, ranks)
    return [None if t is None else total.to(t.device, copy=True)
            for t in parts]


def ppermute(parts: Sequence[torch.Tensor], shift: int,
             ranks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """Slot i receives slot (i − ``shift``)'s tensor (``shift`` ±1); the slot
    with no such sender receives zeros — JAX's ``ppermute`` over the perm
    list [(i, i + shift)] with the wrapped edge masked, as the sharded
    modules use it."""
    if shift not in (1, -1):
        raise ValueError(f"ppermute shifts by +1 or -1, got {shift}")
    n = len(parts)
    if _one_process(ranks):
        return [parts[i - shift].to(t.device, copy=True)
                if 0 <= i - shift < n else torch.zeros_like(t)
                for i, t in enumerate(parts)]
    me = process_rank()
    msgs = [(i - shift, i, parts[i - shift],
             None if parts[i] is None else (parts[i].shape, parts[i].dtype,
                                            parts[i].device))
            for i in range(n) if 0 <= i - shift < n
            and me in (ranks[i], ranks[i - shift])]
    got = route(msgs, ranks)
    return [None if t is None else got[i - shift, i] if 0 <= i - shift < n
            else torch.zeros_like(t) for i, t in enumerate(parts)]


def _to_all(chunks, parts, concat_axis, ranks, shape_of):
    """Slot j's chunks from every slot i (``chunks[i][j]``, this process's
    i only), concatenated in slot order along ``concat_axis``;
    ``shape_of(i, j)`` the shape slot j receives from slot i (None: not
    known before the message, which then sends it first)."""
    n = len(parts)
    if _one_process(ranks):
        return [torch.cat([chunks[i][j].to(parts[j].device)
                           for i in range(n)], dim=concat_axis)
                for j in range(n)]
    me = process_rank()
    msgs = []
    for i in range(n):
        for j in range(n):
            if me in (ranks[i], ranks[j]):
                like = None
                if ranks[j] == me:
                    like = (shape_of and shape_of(i, j), parts[j].dtype,
                            parts[j].device)
                msgs.append((i, j, None if chunks[i] is None
                             else chunks[i][j], like))
    got = route(msgs, ranks, shape_of is not None)
    return [None if parts[j] is None else
            torch.cat([got[i, j] for i in range(n)], dim=concat_axis)
            for j in range(n)]


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int,
               ranks: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """JAX's tiled ``all_to_all``: slot i cuts its tensor into n chunks
    along ``split_axis`` and sends chunk j to slot j, which concatenates the
    chunks it receives in slot order along ``concat_axis``."""
    n = len(parts)
    for t in local_parts(parts):
        if t.shape[split_axis] % n:
            raise ValueError(
                f"split axis of size {t.shape[split_axis]} must be "
                f"divisible by the mesh size {n}")
    chunks = [None if t is None else torch.chunk(t, n, dim=split_axis)
              for t in parts]
    return _to_all(chunks, parts, concat_axis, ranks,
                   lambda i, j: chunks[j][i].shape)


def all_to_all_ragged(parts: Sequence[torch.Tensor], split_axis: int,
                      concat_axis: int, sizes: Sequence[int],
                      ranks: Optional[Sequence[int]] = None,
                      concat_sizes: Optional[Sequence[int]] = None
                      ) -> List[torch.Tensor]:
    """:func:`all_to_all` with uneven chunks: slot i cuts its tensor along
    ``split_axis`` into chunks of ``sizes`` (one per slot, zeros allowed)
    and sends chunk j to slot j, which concatenates the chunks it receives
    in slot order along ``concat_axis``.  ``concat_sizes``: every slot's
    extent along ``concat_axis``, where the caller knows them (across
    ranks it spares a message of shapes before the chunks)."""
    n = len(parts)
    sizes = [int(k) for k in sizes]
    if len(sizes) != n or min(sizes) < 0:
        raise ValueError(f"{len(sizes)} chunk sizes {sizes} for {n} slots")
    for t in local_parts(parts):
        if t.shape[split_axis] != sum(sizes):
            raise ValueError(
                f"split axis of size {t.shape[split_axis]} is not the sum "
                f"of the chunk sizes {sizes}")
    chunks = [None if t is None else torch.split(t, sizes, dim=split_axis)
              for t in parts]

    def shape_of(i, j):
        shape = list(parts[j].shape)
        shape[split_axis], shape[concat_axis] = sizes[j], concat_sizes[i]
        return tuple(shape)

    return _to_all(chunks, parts, concat_axis, ranks,
                   None if concat_sizes is None else shape_of)


def shard_chains(states, mesh: Mesh, axis_name: str = "chains"):
    """A chain-stacked state (or any dataclass of chain-stacked tensors)
    cut into the mesh's slots along the chain axis: a list, slot i's chains
    on its device (None on the slots of other ranks).  ``n_chains`` must
    be a multiple of the axis size."""
    import dataclasses

    devices = mesh.rows(axis_name)[0]
    fields = {f.name: split(getattr(states, f.name), devices)
              for f in dataclasses.fields(states)}
    return [type(states)(**{name: parts[i] for name, parts in fields.items()})
            if m else None for i, m in enumerate(devices.local())]
