"""Mesh-sharded convolution and the halo primitives, on per-slot tensors.

Counterpart of ``deconv3d_tpu/parallel/sharded.py``.  The separable
instrument convolution spans a mesh axis:

  * spatial stage (FSF): λ-planes are independent, so it runs on each
    slot's own λ-planes with the matching slice of the FSF bank;
  * spectral stage (LSF): it mixes wavelengths, so the λ-sharded cube is
    re-sharded by spaxel rows with an ``all_to_all`` (``parallel/mesh.py``),
    convolved locally, and swapped back.

``halo_exchange`` hands every slot its neighbours' edge rows (zeros at the
domain's ends, the zero padding of the single-device layout), and
``sharded_chi2`` sums χ² over the slots.  A sharded tensor is the list of
the slots' tensors, slot order along the mesh axis.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import convolve as cv
from .mesh import all_to_all, ppermute, slot_sum


def convolve_cube_sharded(clean: Sequence[torch.Tensor],
                          fsf_bank: torch.Tensor, lsf_bank: torch.Tensor,
                          spatial: str = "fft") -> List[torch.Tensor]:
    """Separable instrument convolution of a λ-sharded cube.

    ``clean``: the slots' ``[L/D, Y, X]`` λ-blocks of an ``[L, Y, X]`` cube
    (L and Y divisible by the slot count D); returns the convolved cube's
    λ-blocks on the same slots.  The spectral stage runs spaxel-row-sharded
    between two ``all_to_all`` swaps on the whole ``[L, lw]`` LSF bank; the
    spatial stage on each slot's λ-planes with its rows of the FSF bank
    (``[L, f, f]``, or one ``[f, f]`` kernel for every plane)."""
    D = len(clean)
    L = sum(int(c.shape[0]) for c in clean)
    Y = int(clean[0].shape[1])
    if L % D or Y % D or any(c.shape[0] != L // D for c in clean):
        raise ValueError(
            f"L={L} and Y={Y} must be divisible by the mesh axis size {D}")
    if fsf_bank.ndim == 2:
        fsf_bank = fsf_bank[None]
    if fsf_bank.shape[0] == 1:
        fsf_bank = fsf_bank.expand((L,) + tuple(fsf_bank.shape[1:]))
    # λ-sharded [L/D, Y, X] → spaxel-row-sharded [L, Y/D, X]
    rows = all_to_all(clean, split_axis=1, concat_axis=0)
    rows = [cv.apply_lsf_banded(r, lsf_bank.to(r.device, r.dtype))
            for r in rows]
    # back to λ-sharded for the per-plane spatial stage
    planes = all_to_all(rows, split_axis=0, concat_axis=1)
    fn = cv.apply_fsf if spatial == "fft" else cv.apply_fsf_direct
    nl = L // D
    return [fn(c, fsf_bank[d * nl:(d + 1) * nl].to(c.device, c.dtype))
            for d, c in enumerate(planes)]


def halo_exchange(x: Sequence[torch.Tensor], halo: int,
                  edge_axis: int = 0):
    """``(from_prev, from_next)``: per slot the previous slot's last
    ``halo`` rows and the next slot's first ``halo`` rows along
    ``edge_axis``, zeros at the domain's ends."""
    top = [t.narrow(edge_axis, 0, halo) for t in x]
    bot = [t.narrow(edge_axis, t.shape[edge_axis] - halo, halo) for t in x]
    # my bottom rows go to the next slot, my top rows to the previous one
    return ppermute(bot, 1), ppermute(top, -1)


def sharded_chi2(data: Sequence[torch.Tensor], model: Sequence[torch.Tensor],
                 weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global χ² of sharded (data, model, weights): each slot's float32 sum,
    the sums added in slot order on the first slot's device."""
    parts = []
    for d, m, w in zip(data, model, weights):
        r = d - m
        parts.append(torch.sum(r * r * w, dtype=torch.float32))
    return slot_sum(parts)
