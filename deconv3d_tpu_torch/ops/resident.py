"""The resident whole-cube sweep kernel's plan, dispatch rule and plain
pieces (``csrc/resident_sweep.cu``, modes ``'mh'`` and ``'gibbs'``).

The resident kernel is a Hopper redesign of K1
(``deconv3d_tpu/ops/pallas_sweep.py::_make_kernel``): where the TPU kernel
keeps the residual in VMEM for a whole segment, it keeps the whole state
in the SMs' shared memory for a whole sweep, split by wavelength.  Block b
of a grid of one block per SM owns the slab λ ∈ [b·λ_b, (b+1)·λ_b) of the
residual, the weights, the clean cube and (MH) quad, loads it once per
sweep and writes it back at the end.  Everything a color step does at one
wavelength (the patch contraction, the commit) runs on the slab; what
crosses wavelengths goes through global memory and one grid barrier per
color:

  * MH: the per-λ Δχ² shares of every spaxel, which every block reduces in
    classic K1's order and so reaches the same decision; the jumps' LSF
    halo is recomputed from the Philox draws (or read from the injected
    uniforms).
  * gibbs: lin of every spaxel; each block then runs the ``lw`` λ-phases
    redundantly over its window [a − :func:`window_margins` [0],
    b + [1]) ∩ [0, L), which gives its slab's jumps and g bit for bit (see
    :func:`window_margins`), and a tail after the last color reduces the
    per-λ Δχ² terms in classic K1's order.

:func:`plan_slabs` decides whether a problem fits (the cuda engine then
takes the resident kernel; ``ops/sweep.py``), :func:`sweep_kernel` is the
dispatch rule, and :func:`windowed_phases_reference` is the plain version
of the gibbs window step, held against the full-spectrum phase loop.
The resident kernel computes classic K1's function bit for bit, so its
plain version is K1's: ``ops.sweep.mh_segment_reference`` /
``gibbs_segment_reference``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: an H100 SXM's streaming multiprocessors and the shared memory one block
#: can opt in to (bytes): the plan's device when no CUDA device is given
H100_SMS = 132
H100_SMEM_OPTIN = 232_448

_MAX_WARPS = 18       # csrc/sweep_common.cuh kMaxWarps


def window_margins(lw: int) -> Tuple[int, int]:
    """(left, right): how far below and above its slab a block runs the
    gibbs λ-phases so that its slab's jumps and g are exact.

    A phase's jump at λ reads lin within ±lw//2 and its lin update reads
    the jumps within ±lw//2, so a window edge's error moves inwards by up
    to lw − 1 per phase.  Phase ph draws λ ≡ ph (mod lw), so the drawn
    voxels move one wavelength up per phase: after the first phase the
    lower edge's error moves by exactly 1 per phase (2·(lw − 1) in all),
    the upper edge's by lw − 1 (lw·(lw − 1) in all).  Both are tight: one
    wavelength less breaks some slab (``tests/test_torch_resident.py``).
    """
    return 2 * (lw - 1), lw * (lw - 1)


def smem_bytes(mode: str, C: int, f: int, ny: int, nx: int, L: int, S: int,
               lw: int, lam_b: int, positivity: bool = False) -> int:
    """Dynamic shared memory of one resident block (the layout of
    ``csrc/resident_sweep.cu::resident_layout``): the slabs of resid (C
    chains), weights, clean (C chains) and, for MH, quad, plus one color's
    working set; with ``positivity`` the gibbs window keeps two arrays
    more (the second uniforms and the starting clean).  MH's per-λ Δχ²
    shares take none: a warp per (chain, spaxel) reduces them from global
    memory in registers."""
    nw = min(f, _MAX_WARPS)
    nij = ny * nx
    cs = C * nij                           # (chain, spaxel) of a color
    Hp, Wp, Yc, Xc = f - 1 + ny * f, f - 1 + nx * f, ny * f, nx * f
    n = (S * f * f + 2 * C                 # FSF images, Philox keys
         + C * Hp * Wp * lam_b             # resid slab
         + Hp * Wp * lam_b                 # weights slab
         + C * Yc * Xc * lam_b             # clean slab
         + S * lam_b + f * f               # spectra, patch offsets
         + 7 * f * f * cs                  # every color's geometry, flags
         + cs * lam_b * nw * S             # row-group partials of lin
         + 2 * cs * lam_b)                 # lin and g of the slab
    if mode == "mh":
        n += (C * Yc * Xc                  # log-scales
              + Yc * Xc * lam_b            # quad slab
              + lam_b * lw                 # LSF rows of the slab
              + cs * (lam_b + lw - 1)      # jumps with the LSF halo
              + 2 * cs)                    # accept uniforms, decisions
    else:
        lo, hi = window_margins(lw)
        wd = min(L, lam_b + lo + hi)
        n += (wd * lw                      # LSF rows of the window
              + 5 * cs * wd                # lin, quad, qvox, jumps, gacc
              + 2 * cs * wd * positivity   # u2, starting clean
              + 3 * nw)                    # the tail's warp sums
    return 4 * n


def plan_slabs(C: int, f: int, ny: int, nx: int, L: int, S: int, lw: int,
               mode: str, n_sm: int = H100_SMS,
               smem_optin: int = H100_SMEM_OPTIN, positivity: bool = False
               ) -> Optional[Tuple[int, int]]:
    """(λ_b, blocks): the slab width and block count of the resident
    kernel on a card of ``n_sm`` SMs and ``smem_optin`` bytes of shared
    memory per block, or None when the state does not fit.  The slab is the
    narrowest that spreads L over the SMs (a wider one needs more shared
    memory, never less)."""
    if mode not in ("mh", "gibbs"):
        raise ValueError(f"mode must be 'mh' or 'gibbs', got {mode!r}")
    if not 1 <= S <= 8 or lw < 1 or lw % 2 == 0:
        return None
    lam_b = -(-L // n_sm)
    if smem_bytes(mode, C, f, ny, nx, L, S, lw, lam_b,
                  positivity) > smem_optin:
        return None
    return lam_b, -(-L // lam_b)


def device_limits(device) -> Tuple[int, int]:
    """(SMs, opt-in shared memory per block) of a CUDA device."""
    props = torch.cuda.get_device_properties(torch.device(device))
    return props.multi_processor_count, props.shared_memory_per_block_optin


def sweep_kernel(tile, classic: bool, plan) -> str:
    """The kernel a sweep of the cuda engines launches: ``'tiled'`` with a
    tile, ``'classic'`` K1 when pinned or when the state does not fit
    (``plan`` None), else ``'resident'``."""
    if tile is not None:
        return "tiled"
    return "classic" if classic or plan is None else "resident"


def windowed_phases_reference(lin0: torch.Tensor, q: torch.Tensor,
                              qv: torch.Tensor, normal: torch.Tensor,
                              live: torch.Tensor, lsf: torch.Tensor, a: int,
                              b: int, margins: Optional[Tuple[int, int]] = None,
                              clean0: Optional[torch.Tensor] = None):
    """The gibbs λ-phases as a resident block runs them for its slab
    [a, b): the full-spectrum loop (``ops.sweep.gibbs_phases``) over the
    window [a − left, b + right) ∩ [0, L) alone.  Returns (gacc, emitted)
    of the slab; with the default ``margins`` (:func:`window_margins`) they
    equal the full loop's bit for bit.  ``clean0`` (positivity) and
    ``normal`` as in ``gibbs_phases``."""
    from .sweep import gibbs_phases

    L, lw = lsf.shape
    left, right = window_margins(lw) if margins is None else margins
    lo, hi = max(0, a - left), min(L, b + right)
    gacc, emitted = gibbs_phases(
        lin0[..., lo:hi], q[..., lo:hi], qv[..., lo:hi], normal[..., lo:hi],
        live[..., lo:hi], lsf[lo:hi], lam0=lo,
        clean0=None if clean0 is None else clean0[..., lo:hi])
    return gacc[..., a - lo:b - lo], emitted[..., a - lo:b - lo]
