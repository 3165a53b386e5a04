"""Device meshes and the collectives of the sharded paths, in one process.

Counterpart of ``deconv3d_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process drives every device of a
``jax.sharding.Mesh`` through ``shard_map``, and XLA's collectives move the
data.  The port keeps that shape.  A :class:`Mesh` is an array of
``torch.device`` slots with named axes, 1-D or 2-D; one process holds a
tensor per slot, and the collectives below are explicit copies between the
slots' tensors (device to device; on a CUDA device never through the
host).  Slots may repeat a device: ``Mesh([cuda:0] * 2, ("sp",))`` runs
two shards, and their strip exchanges, on one card.  ``all_to_all_ragged``
takes uneven chunks (the sharded direct solve's frequency columns).
Several processes (``torch.distributed``) come with
``parallel/multihost.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with its index (a tensor's ``.device``
    always names one)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D or 2-D array of ``torch.device`` slots with axis names.

    ``devices``: a (nested) sequence of devices or device strings whose
    nesting depth is ``len(axis_names)``.  ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names: Sequence[str] = ("sp",)):
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
        self.devices = nested
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def rows(self, axis_name: str) -> List[List[torch.device]]:
        """The device lists along ``axis_name``: one per index of the other
        axis (one list for a 1-D mesh)."""
        if axis_name not in self.axis_names:
            raise ValueError(
                f"mesh has no {axis_name!r} axis (axes: {self.axis_names})")
        arr = np.moveaxis(self.devices, self.axis_names.index(axis_name), -1)
        return [list(row) for row in arr.reshape(-1, arr.shape[-1])]

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()!r}, {self.axis_names!r})"


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


def split(x: torch.Tensor, devices: Sequence[torch.device],
          dim: int = 0) -> List[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal parts along ``dim``, part i on
    ``devices[i]`` (a copy of its own on every slot)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of size {x.shape[dim]} must be divisible by "
            f"the mesh size {n}")
    return [part.to(dev, copy=True).contiguous()
            for part, dev in zip(torch.chunk(x, n, dim=dim), devices)]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The slots' tensors concatenated along ``dim`` on ``device``."""
    return torch.cat([t.to(device) for t in parts], dim=dim)


def slot_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum over the slots, summed in slot order on the first slot's
    device."""
    total = parts[0]
    for t in parts[1:]:
        total = total + t.to(total.device)
    return total


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`slot_sum`, copied to every slot (JAX's ``psum``)."""
    total = slot_sum(parts)
    return [total.to(t.device, copy=True) for t in parts]


def ppermute(parts: Sequence[torch.Tensor], shift: int) -> List[torch.Tensor]:
    """Slot i receives slot (i − ``shift``)'s tensor (``shift`` ±1); the slot
    with no such sender receives zeros — JAX's ``ppermute`` over the perm
    list [(i, i + shift)] with the wrapped edge masked, as the sharded
    modules use it."""
    if shift not in (1, -1):
        raise ValueError(f"ppermute shifts by +1 or -1, got {shift}")
    n = len(parts)
    out = []
    for i, t in enumerate(parts):
        j = i - shift
        out.append(parts[j].to(t.device, copy=True) if 0 <= j < n
                   else torch.zeros_like(t))
    return out


def all_to_all(parts: Sequence[torch.Tensor], split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """JAX's tiled ``all_to_all``: slot i cuts its tensor into n chunks
    along ``split_axis`` and sends chunk j to slot j, which concatenates the
    chunks it receives in slot order along ``concat_axis``."""
    n = len(parts)
    for t in parts:
        if t.shape[split_axis] % n:
            raise ValueError(
                f"split axis of size {t.shape[split_axis]} must be "
                f"divisible by the mesh size {n}")
    chunks = [torch.chunk(t, n, dim=split_axis) for t in parts]
    return [torch.cat([chunks[i][j].to(parts[j].device) for i in range(n)],
                      dim=concat_axis) for j in range(n)]


def all_to_all_ragged(parts: Sequence[torch.Tensor], split_axis: int,
                      concat_axis: int,
                      sizes: Sequence[int]) -> List[torch.Tensor]:
    """:func:`all_to_all` with uneven chunks: slot i cuts its tensor along
    ``split_axis`` into chunks of ``sizes`` (one per slot, zeros allowed)
    and sends chunk j to slot j, which concatenates the chunks it receives
    in slot order along ``concat_axis``."""
    n = len(parts)
    sizes = [int(k) for k in sizes]
    if len(sizes) != n or min(sizes) < 0:
        raise ValueError(f"{len(sizes)} chunk sizes {sizes} for {n} slots")
    for t in parts:
        if t.shape[split_axis] != sum(sizes):
            raise ValueError(
                f"split axis of size {t.shape[split_axis]} is not the sum "
                f"of the chunk sizes {sizes}")
    chunks = [torch.split(t, sizes, dim=split_axis) for t in parts]
    return [torch.cat([chunks[i][j].to(parts[j].device) for i in range(n)],
                      dim=concat_axis) for j in range(n)]


def shard_chains(states, mesh: Mesh, axis_name: str = "chains"):
    """A chain-stacked state (or any dataclass of chain-stacked tensors)
    cut into the mesh's slots along the chain axis: a list, slot i's chains
    on its device.  ``n_chains`` must be a multiple of the axis size."""
    import dataclasses

    devices = mesh.rows(axis_name)[0]
    fields = {f.name: split(getattr(states, f.name), devices)
              for f in dataclasses.fields(states)}
    return [type(states)(**{name: parts[i] for name, parts in fields.items()})
            for i in range(len(devices))]
