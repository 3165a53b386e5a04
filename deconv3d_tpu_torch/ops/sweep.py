"""Sweep segments: the CUDA kernels' wrappers and their plain torch versions.

Counterpart of ``deconv3d_tpu/ops/pallas_sweep.py`` (modes ``'mh'`` and
``'gibbs'``, any chain batch C).  :func:`mh_segment` and
:func:`gibbs_segment` run each sweep through a hand-written kernel when the
problem lives on a CUDA device — one launch per sweep for the whole batch
of chains: the resident kernel ``csrc/resident_sweep.cu`` where the state
fits the card's shared memory (``ops/resident.py``), classic K1
``csrc/mh_sweep.cu`` / ``csrc/gibbs_sweep.cu`` elsewhere — and take
:func:`mh_segment_reference` / :func:`gibbs_segment_reference`, the same
sweep in plain torch, only for tensors on the CPU.  All four — and the
tiled segments of ``ops/tiled.py``, which visit the same spaxels
tile-major — share everything around the sweep:

  * the λ-contiguous segment layout (``[C, Hp, Wp, L]`` residual, shared
    ``[Hp, Wp, L]`` weights, ``[C, Yc, Xc, L]`` clean, ``[Yc, Xc, L]`` quad
    and qvox), set up at the segment start and undone at its end; classic
    K1 and the tiled kernel take the residual and the weights with rows
    padded to 16 bytes, which their asynchronous patch copies need, and the
    weights as bfloat16 (exact: ``Problem.w_bf16``);
  * per-(sweep, chain, color, spaxel) outputs — MH: the accept flag and the
    proposed Δχ²; gibbs: the number of voxels drawn and the Δχ² of the
    color's committed draws — summed per (sweep, chain) in float64 after
    the segment's launches, as ``_assemble`` does in the JAX package, and
    carried into each chain's running χ² by one Kahan scan over the sweeps
    (:func:`chi2_scan`: ``csrc/chi2_scan.cu`` on a card);
  * the posterior accumulators, flux and monitored voxels as plain torch
    ops after every sweep, batched over the chains; the traces as
    whole-segment ops after the last.

A state is one chain's, or chain-stacked (a leading chain axis on every
field).  Chains in a batch share the problem and advance in lockstep: their
sweep counters must be equal.  Random numbers come from Philox keyed by
(chain key, ABSOLUTE sweep, color, spaxel row, λ, stream)
(``ops/philox.py``), so segmentation, resume and batching are bit-exact: a
chain draws the same numbers alone or in a batch.  For parity tests every
function takes injected ``uniforms`` in place of the generator: MH
``[n_sweeps, (C,) n_colors, nij, L + 1]`` (the L jump uniforms and the
accept uniform of every decision), gibbs ``[n_sweeps, (C,) n_colors, nij,
2, L]`` (the Box-Muller pair of every voxel).
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import chains as ch
from .. import convolve as cv
from .. import metrics
from .. import sampler as sm
from . import banded, philox, resident, truncnorm


@dataclasses.dataclass
class Segment:
    """A segment's ChainResult plus its per-(sweep, color, spaxel) outputs
    (a chain axis after the sweep axis for a chain-stacked state)."""

    result: sm.ChainResult
    accept: torch.Tensor    # MH: accept flag 1/0; gibbs: voxels drawn
    dchi: torch.Tensor      # MH: proposed Δχ²; gibbs: committed Δχ²
    uniforms: Optional[torch.Tensor] = None   # the draws, when recorded


@dataclasses.dataclass
class _SweepState:
    """Segment-layout tensors one sweep reads and updates in place."""

    # the ring kernels (classic K1, the tiled kernel) take resid and w with
    # rows padded to Ls = :func:`ring_row` (L) elements (the first L are
    # data): a tensor map of the Tensor Memory Accelerator needs strides of
    # 16 bytes; their w is bfloat16, the same values as the problem's
    resid: torch.Tensor      # [C, Hp, Wp, L] (ring kernels: Ls)
    w: torch.Tensor          # [Hp, Wp, L] (ring kernels: Ls, bfloat16)
    quad: torch.Tensor       # [Yc, Xc, L]
    qvox: Optional[torch.Tensor]   # [Yc, Xc, L] (gibbs)
    quad_lo: Optional[torch.Tensor]   # [Yc, Xc, L] (gibbs; None = zero)
    clean: torch.Tensor      # [C, Yc, Xc, L]
    log_scale: torch.Tensor  # [C, Yc, Xc]
    valid: torch.Tensor      # [Yc, Xc] float 1/0
    spec: torch.Tensor       # [S, L]
    imgs: torch.Tensor       # [S, f, f]
    lsf: torch.Tensor        # [L, lw]
    f: int
    ny: int
    nx: int
    keys: List[int]          # per-chain 64-bit Philox keys
    target: float
    # (nyt, nxt) block rows / columns of a tile for the tiled scan; None =
    # the whole-cube scan (one step per color over the whole field)
    tile: Optional[Tuple[int, int]] = None
    # the tiled scan's schedule: waves of raster tile indices, each wave's
    # tiles updated side by side color by color (ops/tiled.py
    # wave_schedule); None = every tile a wave of its own (the raster)
    waves: Optional[List[List[int]]] = None
    key_words: Optional[torch.Tensor] = None   # [C, 2] int32, kernel only
    scratch: Optional[torch.Tensor] = None     # kernel workspace, reused
    wave_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    # a band of the tiled scan (parallel/kernel_sharded.py): (first block
    # row, block rows) of the carried grid that the scan covers (None: all
    # of it), and the field's block row of the carried row 0, which keys
    # the kernel's random numbers (a shard's first row)
    rows: Optional[Tuple[int, int]] = None
    gy0: int = 0
    # the kernels' tuning knobs (measurements set them; the defaults are
    # the shipped rules): ring stages (-1: as many as fit, 0: synchronous
    # loads) and the wavelengths per slab of gibbs phase (b) (None:
    # :func:`phase_slab`)
    stages: int = -1
    lam_b: Optional[int] = None
    # the kernel every sweep launches ('resident', 'classic' or 'tiled';
    # ops/resident.py sweep_kernel) and the resident kernel's (λ_b, blocks)
    kernel: str = "classic"
    plan: Optional[Tuple[int, int]] = None
    # config.positivity: MH reflects each proposal into the positive
    # orthant, gibbs draws each voxel from its truncated conditional
    positivity: bool = False
    # [f², C, ny, nx, L, lw] every color's banded Cholesky factors, one
    # copy per chain, and [L, L] the dense LSF matrix (gibbs_block)
    chol: Optional[torch.Tensor] = None
    band: Optional[torch.Tensor] = None
    # config.lambda_chunk: the plain steps read and commit a color's slab
    # this many λ-planes at a time (0: all of them at once)
    lam_chunk: int = 0

    @property
    def C(self) -> int:
        return self.resid.shape[0]

    @property
    def nyt(self) -> int:
        return self.ny if self.tile is None else self.tile[0]

    @property
    def nxt(self) -> int:
        return self.nx if self.tile is None else self.tile[1]

    @property
    def band_rows(self) -> Tuple[int, int]:
        """(first block row, block rows) of the scan in the carried grid."""
        return self.rows if self.rows is not None else (0, self.ny)

    def schedule(self) -> List[List[int]]:
        """The waves of raster tile indices of the band, in order (the whole
        field is one tile)."""
        if self.waves is not None:
            return self.waves
        n_tiles = (self.band_rows[1] // self.nyt) * (self.nx // self.nxt)
        return [[t] for t in range(n_tiles)]

    def wave_origins(self):
        """Per wave, the (by0, bx0) block origins of its tiles in the
        carried grid."""
        ntx, by_base = self.nx // self.nxt, self.band_rows[0]
        return [[(by_base + (t // ntx) * self.nyt, (t % ntx) * self.nxt)
                 for t in wave] for wave in self.schedule()]

    @property
    def max_spaxels(self) -> int:
        """(chain, spaxel)s of the largest step."""
        return self.C * max(map(len, self.schedule())) * self.nyt * self.nxt

    def lam_bounds(self) -> List[Tuple[int, int]]:
        """The (lo, hi) λ-ranges of the plain steps' slab reads and commits
        (the JAX package's ``_slab_bounds``): every plane's contraction and
        commit is its own, so chunking changes no bit, only the size of
        the ``[C, nyt, f, nxt, f, hi − lo]`` temporaries."""
        L, lc = self.spec.shape[1], self.lam_chunk
        if lc <= 0 or lc >= L:
            return [(0, L)]
        return [(lo, min(lo + lc, L)) for lo in range(0, L, lc)]


def _lambda_last(t: torch.Tensor) -> torch.Tensor:
    """[..., L, A, B] → contiguous [..., A, B, L]."""
    return t.movedim(-3, -1).contiguous()


#: the kernels that copy patches through the ring of ``csrc/
#: sweep_common.cuh``: their rows are padded, their weights bfloat16
RING_KERNELS = ("classic", "tiled")


def ring_row(L: int) -> int:
    """Ls = 8⌈L/8⌉, the ring kernels' padded row: 16 bytes of bfloat16
    weights, a multiple of 16 bytes of the float32 residual too."""
    return -(-L // 8) * 8


def _lambda_last_padded(t: torch.Tensor,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[..., L, A, B] → contiguous [..., A, B, Ls] in ``dtype`` (default
    ``t``'s), Ls = :func:`ring_row` (L), zeros past L; written straight
    from ``t``, with no λ-last copy in ``t``'s dtype."""
    L = t.shape[-3]
    out = t.new_zeros((*t.shape[:-3], *t.shape[-2:], ring_row(L)),
                      dtype=dtype)
    out[..., :L] = t.movedim(-3, -1)
    return out


def _lambda_first(t: torch.Tensor) -> torch.Tensor:
    """[..., A, B, L] → contiguous [..., L, A, B]."""
    return t.movedim(-1, -3).contiguous()


def _cells(t: torch.Tensor, ny: int, f: int, nx: int) -> torch.Tensor:
    """[C, Yc, Xc, ...] → view [C, ny, f, nx, f, ...]."""
    return t.view(t.shape[0], ny, f, nx, f, *t.shape[3:])


# ---------------------------------------------------------------------------
# One sweep: plain torch
# ---------------------------------------------------------------------------

def _lsf_band(v: torch.Tensor, lsf: torch.Tensor) -> torch.Tensor:
    """g[..., μ] = Σ_d lsf[μ, d] · v[..., μ + d − lw//2] (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    vp = torch.nn.functional.pad(v, (half, half))
    out = torch.zeros_like(v)
    for d in range(lw):
        out = out + lsf[:, d] * vp[..., d : d + L]
    return out


def _lsf_band_T(v: torch.Tensor, lsf: torch.Tensor) -> torch.Tensor:
    """The transpose band: out[..., l] = Σ_d lsf[l + half − d, d] ·
    v[..., l + half − d] (zero outside)."""
    L, lw = lsf.shape
    half = lw // 2
    vp = torch.nn.functional.pad(v, (half, half))
    lsfp = torch.nn.functional.pad(lsf, (0, 0, half, half))
    out = torch.zeros_like(v)
    for d in range(lw):
        o = 2 * half - d
        out = out + lsfp[o : o + L, d] * vp[..., o : o + L]
    return out


def _at(k: _SweepState, t: torch.Tensor, cy: int, cx: int, by0: int,
        bx0: int) -> torch.Tensor:
    """View of a ``[C', Yc, Xc, ...]`` tensor at the step's spaxels: color
    (cy, cx), block rows / columns from (by0, bx0) → ``[C', nyt, nxt, ...]``."""
    return _cells(t, k.ny, k.f, k.nx)[
        :, by0 : by0 + k.nyt, cy, bx0 : bx0 + k.nxt, cx]


def _at_rows(k: _SweepState, t: torch.Tensor, by0: int,
             bx0: int) -> torch.Tensor:
    """View of a ``[C', nij, ...]`` tensor (spaxel rows) at the step's
    spaxels → ``[C', nyt, nxt, ...]``."""
    return t.view(t.shape[0], k.ny, k.nx, *t.shape[2:])[
        :, by0 : by0 + k.nyt, bx0 : bx0 + k.nxt]


def _color_lin(k: _SweepState, cy: int, cx: int, by0: int, bx0: int):
    """The step's residual patches ``[C, nyt, f, nxt, f, L]`` (a view) and
    ``lin[C, nyt, nxt, L] = Σ_s spec_s · Σ_ab img_s · (resid·w)`` over them,
    λ-chunk by λ-chunk (``_SweepState.lam_bounds``)."""
    f, nyt, nxt = k.f, k.nyt, k.nxt
    L = k.spec.shape[1]
    y0, x0 = cy + by0 * f, cx + bx0 * f
    rblk = k.resid[:, y0 : y0 + nyt * f, x0 : x0 + nxt * f].view(
        k.C, nyt, f, nxt, f, L)
    wblk = k.w[y0 : y0 + nyt * f, x0 : x0 + nxt * f].view(nyt, f, nxt, f, L)
    parts = []
    for lo, hi in k.lam_bounds():
        pooled = torch.einsum("sab,ciajbl->csijl", k.imgs,
                              rblk[..., lo:hi] * wblk[..., lo:hi])
        parts.append((k.spec[None, :, None, None, lo:hi] * pooled).sum(dim=1))
    return rblk, parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def patch_delta(k: _SweepState, g: torch.Tensor, lo: int = 0,
                hi: Optional[int] = None) -> torch.Tensor:
    """The residual delta Σ_s (spec_s · g) ⊗ img_s ``[C, n, f, m, f, hi −
    lo]`` of a committed g ``[C, n, m, L]`` (n × m spaxels of one color) on
    the λ-planes [lo, hi)."""
    gl = g[..., lo:hi]
    delta = gl.new_zeros((*g.shape[:2], k.f, g.shape[2], k.f, gl.shape[-1]))
    for s in range(k.spec.shape[0]):
        gs = k.spec[s, lo:hi] * gl                             # [C,n,m,λ]
        delta = delta + (gs[:, :, None, :, None, :]
                         * k.imgs[s][None, None, :, None, :, None])
    return delta


def _commit(k: _SweepState, rblk: torch.Tensor, gacc: torch.Tensor) -> None:
    """resid −= Σ_s (spec_s · gacc) ⊗ img_s over the color's patches,
    λ-chunk by λ-chunk (:func:`patch_delta`)."""
    for lo, hi in k.lam_bounds():
        rblk[..., lo:hi] -= patch_delta(k, gacc, lo, hi)


def _steps(k: _SweepState):
    """The (color, by0, bx0) steps of one tiled or whole-cube sweep: the
    waves in order (``_SweepState.wave_origins``), inside a wave the colors
    in order, each over the wave's tiles."""
    for wave in k.wave_origins():
        for c, (by0, bx0) in itertools.product(range(k.f * k.f), wave):
            yield c, by0, bx0


def _mh_step_torch(k: _SweepState, c: int, by0: int, bx0: int, adapt: float,
                   u: torch.Tensor, accept_out: torch.Tensor,
                   dchi_out: torch.Tensor) -> torch.Tensor:
    """One MH step of a plain sweep (:func:`_sweep`, in the order of
    :func:`_steps`): color ``c``'s spaxels in the tile at block (by0, bx0),
    with the uniforms ``u`` ``[C, n_colors, nij, L+1]``; updates ``k`` in
    place and returns the g it committed (:func:`_commit`)."""
    f = k.f
    L = k.spec.shape[1]
    pi = torch.tensor(math.pi, dtype=k.resid.dtype)
    cy, cx = divmod(c, f)
    rblk, lin = _color_lin(k, cy, cx, by0, bx0)
    v = _at(k, k.valid[None], cy, cx, by0, bx0)[0]        # [nyt,nxt]
    ls = _at(k, k.log_scale, cy, cx, by0, bx0)            # view
    q = _at(k, k.quad[None], cy, cx, by0, bx0)[0]         # [.., L]
    uc = _at_rows(k, u[:, c], by0, bx0)
    draw = torch.clamp(torch.tan(pi * (uc[..., :L] - 0.5)), -1e3, 1e3)
    jumps = torch.exp(ls)[..., None] * draw * v[..., None]
    if k.positivity:
        # reflective proposal c' = |c + J|: its folded density is
        # symmetric, so the Metropolis ratio needs no correction
        cur = _at(k, k.clean, cy, cx, by0, bx0)
        jumps = torch.abs(cur + jumps) - cur
    g = _lsf_band(jumps, k.lsf)
    dchi = (g * g * q - 2.0 * g * lin).sum(dim=-1)        # [C,nyt,nxt]
    accf = ((torch.log(uc[..., L]) < -0.5 * dchi) & (v > 0)).to(g.dtype)
    g = g * accf[..., None]
    _commit(k, rblk, g)
    _at(k, k.clean, cy, cx, by0, bx0)[...] += jumps * accf[..., None]
    ls += adapt * (accf - k.target) * v
    _at_rows(k, accept_out[:, c], by0, bx0)[...] = accf
    _at_rows(k, dchi_out[:, c], by0, bx0)[...] = dchi
    return g


def truncated_jump(linT: torch.Tensor, qs: torch.Tensor, cur: torch.Tensor,
                   u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """A voxel's positivity draw as a jump from its current value ``cur``:
    c' ~ N(μ, σ²) truncated to c' ≥ 0, μ = cur + linT/qs, σ = qs^−½, from
    the uniform pair (u1, u2) (``ops/truncnorm.py``): with α = −μ/σ =
    −σ·(cur·qs + linT) (no division) and the draw's excess d = z − α over
    its bound, c' = σ·d.  c' is clamped at 0, where float32 rounding can
    land a hair below it, so the chain never leaves the orthant
    (``csrc/gibbs_step.cuh`` ``truncated_jump`` computes the same)."""
    sig = torch.rsqrt(qs)
    alpha = -sig * (cur * qs + linT)
    d = truncnorm.excess(alpha, u1, torch.log(u2))
    return torch.clamp(sig * d, min=0.0) - cur


def gibbs_phases(lin0: torch.Tensor, q: torch.Tensor, qv: torch.Tensor,
                 normal: torch.Tensor, live: torch.Tensor, lsf: torch.Tensor,
                 lam0: int = 0, clean0: Optional[torch.Tensor] = None):
    """The ``lw`` λ-phases of one gibbs step over the wavelengths
    ``lam0 .. lam0 + n − 1`` (the last axis of every tensor; ``lsf`` holds
    their rows): phase ph draws the live voxels λ ≡ ph (mod lw) from
    N(linT/qvox, 1/qvox) and updates lin ← lin − g·quad.  Wavelengths
    outside the range count as absent, as outside the spectrum.  With
    ``clean0``, the step's starting clean (positivity), ``normal`` holds
    the uniform pairs ``[..., 2, n]`` instead and each draw is
    :func:`truncated_jump` (a voxel's clean is ``clean0`` until its own
    phase draws it).  Returns (gacc, emitted): the summed g and the drawn
    jumps."""
    n, lw = lsf.shape
    phase = (lam0 + torch.arange(n, device=lin0.device)) % lw
    qs = torch.clamp(qv, min=1e-30)
    lin = lin0
    gacc = torch.zeros_like(lin)
    emitted = torch.zeros_like(lin)
    for ph in range(lw):
        sel = live * (phase == ph).to(lin0.dtype)
        if clean0 is None:
            jumps = sel * (_lsf_band_T(lin, lsf) / qs
                           + normal * torch.rsqrt(qs))
        else:
            tj = truncated_jump(_lsf_band_T(lin, lsf), qs, clean0,
                                normal[..., 0, :], normal[..., 1, :])
            jumps = torch.where(sel > 0, tj, torch.zeros_like(tj))
        g = _lsf_band(jumps, lsf)
        lin = lin - g * q
        gacc = gacc + g
        emitted = emitted + jumps
    return gacc, emitted


def slab_phases_reference(lin0: torch.Tensor, q: torch.Tensor,
                          qv: torch.Tensor, normal: torch.Tensor,
                          live: torch.Tensor, lsf: torch.Tensor, lam_b: int,
                          margins: Optional[Tuple[int, int]] = None,
                          clean0: Optional[torch.Tensor] = None):
    """The λ-phases as the kernels' phase (b) runs them (``csrc/
    gibbs_step.cuh``): slab by slab of ``lam_b`` wavelengths, each over its
    own window alone (``ops.resident.windowed_phases_reference``), the
    slabs' results side by side.  With the default ``margins`` it returns
    :func:`gibbs_phases`' (gacc, emitted) bit for bit for any ``lam_b``,
    with positivity (``clean0``) or without."""
    L = lsf.shape[0]
    parts = [resident.windowed_phases_reference(
        lin0, q, qv, normal, live, lsf, a, min(L, a + lam_b), margins,
        clean0=clean0)
        for a in range(0, L, lam_b)]
    return tuple(torch.cat(p, dim=-1) for p in zip(*parts))


def _gibbs_step_torch(k: _SweepState, c: int, by0: int, bx0: int,
                      u: torch.Tensor, live_out: torch.Tensor,
                      dchi_out: torch.Tensor) -> torch.Tensor:
    """One exact-Gibbs step (color ``c`` in the tile at (by0, bx0)) of a
    plain sweep (:func:`_sweep`), with the Box-Muller pairs ``u`` ``[C, n_colors, nij, 2, L]`` (with positivity
    the pairs of :func:`truncated_jump`); updates ``k`` in place and
    returns the committed g.

    lin once from the residual, then the ``lw`` λ-phases, each drawing the
    voxels λ ≡ phase (mod lw) from N(linT/qvox, 1/qvox) and updating lin ←
    lin − g·quad (exact: same-color patches are disjoint), then one
    residual commit of the summed g.  Δχ² of the step is that of the
    summed g against the step's first lin, equal to the phases' sum; its
    g²·quad_lo part is summed on its own, below the float32 ulp of g²·quad
    where it would round away.
    """
    dt = k.resid.dtype
    two_pi = torch.tensor(2.0 * math.pi, dtype=dt)
    cy, cx = divmod(c, k.f)
    rblk, lin0 = _color_lin(k, cy, cx, by0, bx0)
    v = _at(k, k.valid[None], cy, cx, by0, bx0)[0]        # [nyt,nxt]
    q = _at(k, k.quad[None], cy, cx, by0, bx0)[0]         # [.., L]
    qv = _at(k, k.qvox[None], cy, cx, by0, bx0)[0]
    uc = _at_rows(k, u[:, c], by0, bx0)                   # [C,..,2,L]
    live_all = v[..., None] * (qv > 0).to(dt)             # [.., L]
    if k.positivity:
        gacc, emitted = gibbs_phases(
            lin0, q, qv, uc, live_all, k.lsf,
            clean0=_at(k, k.clean, cy, cx, by0, bx0))
    else:
        normal = torch.sqrt(-2.0 * torch.log(uc[..., 0, :])) \
            * torch.cos(two_pi * uc[..., 1, :])
        gacc, emitted = gibbs_phases(lin0, q, qv, normal, live_all, k.lsf)
    dchi = (gacc * gacc * q - 2.0 * gacc * lin0).sum(dim=-1)
    if k.quad_lo is not None:
        qlo = _at(k, k.quad_lo[None], cy, cx, by0, bx0)[0]
        dchi = dchi + (gacc * gacc * qlo).sum(dim=-1)
    _commit(k, rblk, gacc)
    _at(k, k.clean, cy, cx, by0, bx0)[...] += emitted
    _at_rows(k, live_out[:, c], by0, bx0)[...] = live_all.sum(dim=-1)
    _at_rows(k, dchi_out[:, c], by0, bx0)[...] = dchi
    return gacc


def _block_step(k: _SweepState, c: int, u: torch.Tensor,
                live_out: torch.Tensor, dchi_out: torch.Tensor,
                sample) -> torch.Tensor:
    """Color ``c`` of a ``gibbs_block`` sweep with the Box-Muller pairs
    ``u`` ``[C, n_colors, nij, 2, L]``; updates ``k`` in place (the JAX
    package's ``_make_block_gibbs_step``) and returns the committed g.

    Per color: lin from the residual, linT = Mᵀ lin, and every (chain,
    spaxel)'s spectrum jump drawn at once from its exact conditional
    N(A⁻¹ linT, A⁻¹), A = RᵀR, by ``sample(R, linT, noise)`` — the banded
    draw kernel (``ops.banded.sample_conditional``, one launch for the
    color) or its plain loop; then g = M·jump, Δχ² (with its quad_lo part,
    as exact Gibbs sums it), the residual commit and clean += jump.  The
    LSF products are matmuls with the dense LSF matrix M of
    ``convolve.lsf_matrix`` (``k.band``; ``v @ M`` is :func:`_lsf_band_T`,
    ``v @ M.T`` :func:`_lsf_band`): one launch where the band loops take
    2·lw, since the step's launches, not its draw, take most of a color's
    time on the card; the matmul does L/lw times the band's flops, which
    costs nothing at L = 600.  ``k.chol`` holds the factors once per chain
    (made once per segment).  The voxels drawn are valid·L, as the JAX
    package counts them.
    """
    C, L = k.C, k.spec.shape[1]
    cy, cx = divmod(c, k.f)
    uc = u[:, c]                                          # [C, nij, 2, L]
    noise = torch.sqrt(-2.0 * torch.log(uc[..., 0, :])) * torch.cos(
        (2.0 * math.pi) * uc[..., 1, :])
    with cv.no_tf32():
        rblk, lin = _color_lin(k, cy, cx, 0, 0)           # [C,ny,nx,L]
        v = _at(k, k.valid[None], cy, cx, 0, 0)[0]        # [ny,nx]
        q = _at(k, k.quad[None], cy, cx, 0, 0)[0]         # [ny,nx,L]
        # one product per block row: a shard of the field (parallel/
        # sweep_sharded.py) multiplies the same shapes, so it computes the
        # same bits
        linT = torch.stack([lin[:, i] @ k.band for i in range(k.ny)], dim=1)
        draw = sample(k.chol[c], linT,
                      noise.reshape(C, k.ny, k.nx, L).contiguous())
        # masked spaxels have sqrt(EPS) pivots: their draws are discarded
        jumps = torch.where(v[..., None] > 0, draw, torch.zeros_like(draw))
        g = torch.stack([jumps[:, i] @ k.band.T for i in range(k.ny)], dim=1)
        dchi = (g * g * q - 2.0 * g * lin).sum(dim=-1)    # [C,ny,nx]
        if k.quad_lo is not None:
            qlo = _at(k, k.quad_lo[None], cy, cx, 0, 0)[0]
            dchi = dchi + (g * g * qlo).sum(dim=-1)
        _commit(k, rblk, g)
    _at(k, k.clean, cy, cx, 0, 0)[...] += jumps
    live_out[:, c] = (v * L).reshape(1, -1)
    dchi_out[:, c] = dchi.reshape(C, -1)
    return g


# ---------------------------------------------------------------------------
# One sweep: the CUDA kernels
# ---------------------------------------------------------------------------

def _check_cuda(name: str, t: torch.Tensor, device, shape, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def _kernel_args(k: _SweepState, mode: str, u, out_a, out_b, u_out):
    """Checked tensors of one launch, the scratch, the schedule tables of
    the tiled kernel (device ints) and the geometry ints (the padded row
    length Ls after L, but for the resident kernel, which also takes
    float32 weights where the others take bfloat16; after ``lw``: λ_b for
    the resident kernel; the ring stages for the others, before them
    the tile's block rows and columns, the waves and the largest wave's
    tiles for the tiled kernel and after them its band (first block row,
    block rows, the field's block row of the carried row 0), then gibbs
    phase (b)'s λ_b)."""
    from .._build import load_library

    dev = k.resid.device
    f, ny, nx, C = k.f, k.ny, k.nx, k.C
    S, L = k.spec.shape
    lw = int(k.lsf.shape[1])
    nij, n_colors = ny * nx, f * f
    Hp, Wp, Yc, Xc = f - 1 + ny * f, f - 1 + nx * f, ny * f, nx * f
    per = (L + 1,) if mode == "mh" else (2, L)
    ring = k.kernel in RING_KERNELS
    Ls = ring_row(L) if ring else L
    shapes = {
        "resid": (k.resid, (C, Hp, Wp, Ls)),
        "w": (k.w, (Hp, Wp, Ls), torch.bfloat16 if ring else torch.float32),
        "quad": (k.quad, (Yc, Xc, L)), "clean": (k.clean, (C, Yc, Xc, L)),
        "log_scale": (k.log_scale, (C, Yc, Xc)), "valid": (k.valid, (Yc, Xc)),
        "spec": (k.spec, (S, L)), "imgs": (k.imgs, (S, f, f)),
        "lsf": (k.lsf, (L, lw)),
        "out_a": (out_a, (C, n_colors, nij)),
        "dchi_out": (out_b, (C, n_colors, nij)),
    }
    if mode == "gibbs":
        shapes["qvox"] = (k.qvox, (Yc, Xc, L))
    if k.quad_lo is not None:
        shapes["quad_lo"] = (k.quad_lo, (Yc, Xc, L))
    if u is not None:
        shapes["uniforms"] = (u, (C, n_colors, nij, *per))
    if u_out is not None:
        shapes["uniforms_out"] = (u_out, (C, n_colors, nij, *per))
    for name, (t, *spec) in shapes.items():
        _check_cuda(name, t, dev, *spec)
    if not 1 <= S <= 8:
        raise ValueError(f"the kernels take FSF rank 1..8, got {S}")
    if k.key_words is None:
        words = [philox.key_words(key) for key in k.keys]
        k.key_words = torch.tensor(
            [[w - (1 << 32) if w >= 1 << 31 else w for w in pair]
             for pair in words], dtype=torch.int32, device=dev)
    lib = load_library()
    pointers = ()
    if k.kernel == "resident":
        n_scratch = getattr(lib, f"resident_{mode}_scratch_floats")(
            C, L, f, ny, nx)
        dims = (C, L, f, ny, nx, S, lw, k.plan[0], int(k.positivity))
    else:
        n_scratch = (                                      # the largest step's
            lib.mh_sweep_scratch_floats(L, k.max_spaxels) if mode == "mh"
            else lib.gibbs_sweep_scratch_floats(L, k.max_spaxels,
                                                int(k.positivity)))
        extra = (k.stages,)
        if k.tile is not None:
            waves = k.schedule()
            if k.wave_tables is None:
                starts = list(itertools.accumulate(map(len, waves), initial=0))
                k.wave_tables = tuple(
                    torch.tensor(v, dtype=torch.int32, device=dev)
                    for v in (starts, [t for wave in waves for t in wave]))
            pointers = k.wave_tables
            extra = (k.nyt, k.nxt, len(waves), max(map(len, waves)), k.stages,
                     *k.band_rows, k.gy0)
        if mode == "gibbs":
            lam_b = k.lam_b or phase_slab(
                L, k.max_spaxels,
                torch.cuda.get_device_properties(dev).multi_processor_count)
            extra = (*extra, lam_b)
        dims = (C, L, Ls, f, ny, nx, S, lw, *extra, int(k.positivity))
    if k.scratch is None or k.scratch.numel() < n_scratch:
        k.scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    return lib, pointers, dims


#: the narrowest and the widest slab of gibbs phase (b): below the first
#: the window's margins (2(lw−1) + lw(lw−1) wavelengths, 130 at lw = 11) are
#: most of a block's work; above the second the 5 window arrays outgrow the
#: shared memory the ring leaves
MIN_PHASE_SLAB = 64
MAX_PHASE_SLAB = 1024


def phase_slab(L: int, spaxels: int, n_sm: int) -> int:
    """λ_b, the wavelengths per slab of gibbs phase (b) (``csrc/
    gibbs_step.cuh``): each of a step's ``spaxels`` (chain, spaxel)s runs its
    λ-phases on ⌈L / λ_b⌉ blocks, each over its slab plus the window
    margins.  The slabs spread the step over the card's ``n_sm`` SMs —
    ⌈n_sm / spaxels⌉ of them per (chain, spaxel) — no narrower than
    :data:`MIN_PHASE_SLAB` and no wider than :data:`MAX_PHASE_SLAB`.  Any
    λ_b gives the same bits."""
    n_slabs = max(-(-n_sm // max(spaxels, 1)), -(-L // MAX_PHASE_SLAB))
    n_slabs = max(1, min(n_slabs, -(-L // MIN_PHASE_SLAB)))
    return -(-L // n_slabs)


def _count_launch(k: _SweepState, counter, count: str) -> None:
    """One more launch on ``counter.<count>``, and on the tracer's counter
    of the instantiation the launcher takes (``launch_variant`` in
    ``csrc/sweep_common.cuh``): ``sweep.launches.rank1`` for an FSF of
    rank 1, else ``sweep.launches.rank_any`` (``kMaxRank``); and on
    ``sweep.launches.w_bf16`` where the launch's weights are bfloat16 (the
    ring kernels')."""
    setattr(counter, count, getattr(counter, count) + 1)
    metrics.count("sweep.launches.rank1" if k.spec.shape[0] == 1
                  else "sweep.launches.rank_any")
    if k.w.dtype == torch.bfloat16:
        metrics.count("sweep.launches.w_bf16")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _sweep_cuda(k: _SweepState, mode: str, sweep: int, adapt: float,
                u: Optional[torch.Tensor], out_a: torch.Tensor,
                out_b: torch.Tensor, u_out: Optional[torch.Tensor],
                counter) -> None:
    """Launch one sweep of ``mode`` for the whole batch:
    ``csrc/resident_sweep.cu`` with a resident plan (counted by
    ``counter.resident_launches``), else classic K1 (``csrc/mh_sweep.cu``,
    ``csrc/gibbs_sweep.cu``) or, with a tile, ``csrc/tiled_sweep.cu``
    (counted by ``counter.launches``); each launch also on the tracer's
    counter of its instantiation (:func:`_count_launch`)."""
    lib, tables, dims = _kernel_args(k, mode, u, out_a, out_b, u_out)
    dev = k.resid.device
    launch = getattr(lib, {"resident": f"resident_{mode}_launch",
                           "classic": f"{mode}_sweep_launch"}.get(
                               k.kernel, f"tiled_{mode}_launch"))
    # the launchers' own fields and scalars: MH's adapt step and target
    own, scalars = (((k.clean, k.log_scale), (adapt, k.target))
                    if mode == "mh" else ((k.quad_lo, k.qvox, k.clean), ()))
    with torch.cuda.device(dev):
        err = launch(
            *map(_ptr, (k.resid, k.w, k.quad, *own, k.valid, k.spec, k.imgs,
                        k.lsf, k.key_words, u, out_a, out_b, u_out,
                        k.scratch, *tables)),
            *dims, sweep & philox.M32, *scalars, _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"{launch.__name__} failed: CUDA error {err}")
    _count_launch(k, counter, "resident_launches" if k.kernel == "resident"
                  else "launches")


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

def _chain_keys(keys: torch.Tensor) -> List[int]:
    """64-bit Philox keys of int64 (two's complement) key tensors."""
    return [int(key) & 0xFFFFFFFFFFFFFFFF for key in keys.reshape(-1).tolist()]


def sweep_state(p: sm.Problem, states: sm.SamplerState, mode: str,
                kernel: bool, tile: Optional[Tuple[int, int]] = None,
                classic: bool = False,
                waves: Optional[List[List[int]]] = None, stages: int = -1,
                lam_b: Optional[int] = None,
                rows: Optional[Tuple[int, int]] = None,
                gy0: int = 0) -> _SweepState:
    """The segment layout of the chain-stacked ``states`` on ``p``: the
    tensors one sweep reads and updates in place, for the kernel
    (``kernel``: the resident kernel where the state fits the card's shared
    memory, unless ``classic`` or a ``tile``) or the plain version.
    ``rows`` / ``gy0``: a band of the tiled scan (``_SweepState``)."""
    cfg = p.config
    dev = p.device
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    C = states.clean.shape[0]
    # the kernels are float32-only (_check_cuda); the plain versions run in
    # the problem's dtype, float64 included
    dt = p.w_pad.dtype
    plan, name = None, "classic"
    if mode == "gibbs_block":
        name = "block"                   # torch ops and the banded kernels
    elif kernel:
        if tile is None and not classic:
            plan = resident.plan_slabs(C, f, ny, nx, L, p.fsf_spec.shape[0],
                                       int(p.lsf.shape[1]), mode,
                                       *resident.device_limits(dev),
                                       positivity=bool(cfg.positivity))
        name = resident.sweep_kernel(tile, classic, plan)
    # the ring kernels read padded rows and bfloat16 weights (_SweepState)
    ring = kernel and name in RING_KERNELS
    if ring and not p.w_bf16:
        raise ValueError(
            "the sweep kernels copy the weights as bfloat16, and this "
            "problem's weights are not bfloat16 values (Problem.w_bf16; "
            "make_problem rounds them for every sampler but 'direct')")
    return _SweepState(
        resid=(_lambda_last_padded if ring else _lambda_last)(
            states.resid.to(dt)),
        w=(_lambda_last_padded(p.w_pad, torch.bfloat16) if ring
           else _lambda_last(p.w_pad)),
        quad=_lambda_last(p.quad),
        qvox=_lambda_last(p.qvox) if mode == "gibbs" else None,
        quad_lo=(_lambda_last(p.quad_lo)
                 if mode != "mh" and p.quad_lo is not None else None),
        clean=_lambda_last(states.clean.to(dt)),
        log_scale=states.log_scale.to(dt).clone(),
        valid=p.valid.to(dt).contiguous(),
        spec=p.fsf_spec.contiguous(),
        imgs=p.fsf_imgs.contiguous(),
        lsf=p.lsf.contiguous(),
        f=f, ny=ny, nx=nx, keys=_chain_keys(states.key),
        target=float(cfg.target_acceptance), tile=tile, waves=waves,
        stages=stages, lam_b=lam_b, kernel=name, plan=plan,
        positivity=bool(cfg.positivity),
        chol=None if mode != "gibbs_block" else p.chol.view(
            ny, f, nx, f, L, -1).permute(1, 3, 0, 2, 4, 5).reshape(
            f * f, 1, ny, nx, L, -1).to(dt).expand(
            -1, C, -1, -1, -1, -1).contiguous(),
        band=None if mode != "gibbs_block" else torch.as_tensor(
            cv.lsf_matrix(p.lsf.cpu().numpy()), dtype=dt, device=dev),
        rows=rows, gy0=gy0, lam_chunk=int(cfg.lambda_chunk or 0),
    )


def chi2_scan_reference(committed: torch.Tensor, chi2: torch.Tensor,
                        comp: torch.Tensor):
    """The running χ² over a segment's sweeps: ``committed`` ``[n, C]``
    float32, each sweep's committed Δχ² per chain, carried into ``chi2``
    and its Kahan compensation ``comp`` (``[C]`` float32) in sweep order.
    Returns ``(trace [C, n], chi2, comp)``: χ² after every sweep, and the
    final pair."""
    trace = []
    for row in committed:
        y = row - comp
        t = chi2 + y
        comp = (t - chi2) - y
        chi2 = t
        trace.append(t)
    return torch.stack(trace, dim=1), chi2, comp


def chi2_scan(committed: torch.Tensor, chi2: torch.Tensor,
              comp: torch.Tensor):
    """:func:`chi2_scan_reference`: on CUDA tensors one launch of
    ``chi2_scan_kernel`` (``csrc/chi2_scan.cu``: a thread per chain, the
    same float32 steps, the same bits), counted by ``chi2_scan.launches``;
    on CPU tensors the plain loop."""
    if all(t.device.type == "cpu" for t in (committed, chi2, comp)):
        return chi2_scan_reference(committed, chi2, comp)
    from .._build import load_library

    n, C = committed.shape
    dev = committed.device
    chi2, comp = chi2.contiguous(), comp.contiguous()
    for name, t, shape in (("committed", committed, (n, C)),
                           ("chi2", chi2, (C,)), ("comp", comp, (C,))):
        _check_cuda(name, t, dev, shape)
    trace = torch.empty((C, n), dtype=torch.float32, device=dev)
    chi2_out, comp_out = torch.empty_like(chi2), torch.empty_like(comp)
    with torch.cuda.device(dev):
        err = load_library().chi2_scan_launch(
            *map(_ptr, (committed, chi2, comp, trace, chi2_out, comp_out)),
            n, C, _stream(dev))
    if err != 0:
        raise RuntimeError(f"chi2_scan_launch failed: CUDA error {err}")
    chi2_scan.launches += 1
    return trace, chi2_out, comp_out


chi2_scan.launches = 0


class _Tail(NamedTuple):
    """What a segment's tail makes of its stacked per-sweep outputs, per
    chain: χ² after every sweep and the final Kahan pair, the traces, and
    the segment's accepted and proposed updates."""

    chi2_trace: torch.Tensor      # [C, n] float32
    chi2: torch.Tensor            # [C] float32
    chi2_comp: torch.Tensor       # [C] float32
    accept_trace: torch.Tensor    # [C, n]
    flux_trace: torch.Tensor      # [C, n] float32
    monitor_trace: torch.Tensor   # [C, n, K]
    n_accept: torch.Tensor        # [C] float32
    n_propose: torch.Tensor       # [C] float32


#: the bytes the committed Δχ² reduction of a segment's tail may hold at
#: once: a float64 copy of a run of sweeps' outputs (torch's float64 sum of
#: float32 makes one) and, for MH, their product with the flags.  The
#: benchmark's segments take one run; a long segment of a big field, a few.
TAIL_CHUNK_BYTES = 64 << 20


def _committed_dchi(mode: str, accept: torch.Tensor,
                    dchi: torch.Tensor) -> torch.Tensor:
    """Each (sweep, chain)'s committed Δχ² of ``[n, C, n_colors, nij]``
    outputs, summed in float64: ``[n, C]``.  MH's flags are 0 or 1, so
    their product with Δχ² is exact in Δχ²'s dtype.  Runs of sweeps of at
    most ``TAIL_CHUNK_BYTES`` at a time (on the CPU a sum's bits do not
    depend on the run)."""
    per_sweep = dchi[0].numel() * (8 + dchi.element_size() * (mode == "mh"))
    step = max(1, TAIL_CHUNK_BYTES // max(per_sweep, 1))
    parts = []
    for a in range(0, dchi.shape[0], step):
        d = dchi[a:a + step]
        if mode == "mh":
            d = d * accept[a:a + step]
        parts.append(d.sum(dim=(2, 3), dtype=torch.float64))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _segment_tail(mode: str, accept: torch.Tensor, dchi: torch.Tensor,
                  flux: torch.Tensor, mon: torch.Tensor,
                  order: torch.Tensor, chi2: torch.Tensor,
                  chi2c: torch.Tensor, n_valid: float) -> _Tail:
    """The tail of a segment of ``mode`` as whole-segment ops, with no
    sync: ``accept`` and ``dchi`` ``[n, C, n_colors, nij]`` the sweeps'
    outputs, ``flux`` ``[n, C]`` their flux, ``mon`` ``[n, C, K]`` the
    monitored voxels in the shards' order and ``order`` ``[K]`` their
    slots in the problem's, ``chi2`` / ``chi2c`` ``[C]`` the incoming Kahan
    pair, ``n_valid`` the problem's valid spaxels (a host number).  Each
    (sweep, chain)'s committed Δχ² is summed in float64 and rounded to
    float32 (:func:`_committed_dchi`), then :func:`chi2_scan` carries them
    in sweep order."""
    n, C, K = mon.shape
    f32 = torch.float32
    chi2_trace, chi2, chi2c = chi2_scan(
        _committed_dchi(mode, accept, dchi).to(f32), chi2, chi2c)
    monitor = torch.empty((C, n, K), dtype=mon.dtype, device=mon.device)
    monitor[:, :, order] = mon.transpose(0, 1)
    acc_sweep = accept.sum(dim=(2, 3)).T                        # [C, n]
    n_acc = acc_sweep.sum(dim=1).to(f32)
    if mode != "mh":
        # proposals == exact draws == accepted voxels
        n_prop = n_acc
        acc_trace = torch.ones_like(acc_sweep)
    else:
        n_prop = torch.full_like(n_acc, float(n) * n_valid)
        acc_trace = acc_sweep / max(n_valid, 1.0)
    return _Tail(chi2_trace, chi2, chi2c, acc_trace, flux.T.contiguous(),
                 monitor, n_acc, n_prop)


@dataclasses.dataclass
class _Running:
    """What a segment keeps of one ``_SweepState`` ``k``: the sweeps'
    per-(color, spaxel) outputs, which they write; on a kept sweep its
    clean added to the λ-last accumulators (``sum_sq`` None without
    ``config.track_variance``); after every sweep its flux partial sum
    ``[C]`` float32 and its monitored voxels, ``flat`` their indices into
    its λ-last clean."""

    k: _SweepState
    flat: torch.Tensor
    accept: torch.Tensor          # [n, C, n_colors, k's spaxels]
    dchi: torch.Tensor
    sum_clean: torch.Tensor
    sum_sq: Optional[torch.Tensor]
    flux: List[torch.Tensor] = dataclasses.field(default_factory=list)
    mon: List[torch.Tensor] = dataclasses.field(default_factory=list)

    @classmethod
    def of(cls, k: _SweepState, states: sm.SamplerState, p: sm.Problem,
           flat: torch.Tensor, n_sweeps: int) -> "_Running":
        """``k``'s, from the state it was laid out of (``p``: the field's
        problem)."""
        dt = p.data_pad.dtype
        accept, dchi = (torch.zeros((n_sweeps, k.C, k.f * k.f, k.ny * k.nx),
                                    dtype=dt, device=k.resid.device)
                        for _ in range(2))
        return cls(k, flat, accept, dchi,
                   _lambda_last(states.sum_clean.to(dt)),
                   _lambda_last(states.sum_sq.to(dt))
                   if p.config.track_variance else None)

    def after(self, keep: bool) -> None:
        k = self.k
        if keep:
            self.sum_clean += k.clean
            if self.sum_sq is not None:
                self.sum_sq += k.clean * k.clean
        self.flux.append(torch.sum(k.clean * k.valid[..., None],
                                   dim=(1, 2, 3), dtype=torch.float32))
        self.mon.append(k.clean.reshape(k.C, -1)[:, self.flat])


def _monitored(p: sm.Problem, y0: int = 0, rows: Optional[int] = None):
    """The monitored voxels in the clean rows [y0, y0 + rows) (default:
    every row, and the slots are the identity): their slots in the
    problem's order and their indices into the λ-last clean ``[C, rows,
    Xc, L]`` of those rows, on the problem's device, built once per
    problem."""
    rows = p.Yc if rows is None else rows

    def build():
        mon, Yc, Xc = p.monitor_idx, p.Yc, p.Xc
        lam, yy, xx = mon // (Yc * Xc), (mon % (Yc * Xc)) // Xc, mon % Xc
        inside = ((yy >= y0) & (yy < y0 + rows)).to(p.device)
        return (torch.nonzero(inside).reshape(-1),
                (((yy - y0) * Xc + xx) * p.L + lam).to(p.device)[inside])
    return sm.cached(p, ("monitored", y0, rows), build)


def _segment(p: sm.Problem, state: sm.SamplerState, n_sweeps: int,
             uniforms: Optional[torch.Tensor], record_uniforms: bool,
             mode: str, kernel: bool, lay) -> Segment:
    """The body of every segment of ``mode``, on one device
    (:func:`_run_segment`) or on shards (``parallel/sweep_sharded.py``
    ``sharded_segment``): the checks on its inputs, the schedules, the
    sweeps, the tail and the new state.  ``lay(states)`` lays the
    chain-stacked ``states`` out and returns ``(runs, sweep, outputs,
    fields)``: this process's :class:`_Running` states; ``sweep(s, sweep,
    adapt, u, u_out)``, the s-th sweep on the field's uniforms ``u`` (None:
    the kernels draw their own), recorded in ``u_out`` (or None); after the
    sweeps ``outputs()``, the field's ``(accept, dchi, flux, mon, order)``
    for :func:`_segment_tail`, and ``fields()``, the new state's resid,
    clean, log_scale, sum_clean and sum_sq (None: unchanged), λ-first.

    The tail never waits for the card: the caller's first read of the
    result does.  Spans (``metrics``): ``segment.head`` to the first
    launch, ``segment.tail`` from the last sweep to the return, and
    ``segment.gap`` from the last launch to the next segment's first."""
    span = metrics.span("segment.head").start()
    dev = p.device
    single = state.clean.dim() == 3
    states = ch.stack_chains([state]) if single else state
    if uniforms is not None and single:
        uniforms = uniforms[:, None]
    C, n_colors, nij = states.clean.shape[0], p.n_colors, p.ny * p.nx
    per = (p.L + 1,) if mode == "mh" else (2, p.L)      # gibbs, gibbs_block
    if uniforms is not None and tuple(uniforms.shape) != (
        n_sweeps, C, n_colors, nij, *per
    ):
        lead = f"[{n_sweeps}, " + ("" if single else f"{C}, ")
        raise ValueError(
            f"uniforms must be {lead}{n_colors}, {nij}, "
            f"{', '.join(map(str, per))}], got {tuple(uniforms.shape)}"
        )
    sweep0 = int(states.sweep.reshape(-1)[0])
    if not bool((states.sweep == sweep0).all()):
        raise ValueError(
            "chains in a batch advance in lockstep: their sweep counters "
            f"differ ({states.sweep.tolist()})"
        )
    if mode == "gibbs" and p.qvox is None:
        raise ValueError("a gibbs segment needs problem.qvox "
                         "(make_problem with sampler='gibbs')")
    if mode == "gibbs_block" and p.chol is None:
        raise ValueError("a gibbs_block segment needs problem.chol "
                         "(make_problem with sampler='gibbs_block')")
    ids = sweep0 + torch.arange(n_sweeps, dtype=torch.int64)
    adapt = sm.adapt_schedule(ids, p.config).tolist()
    keep = sm.keep_schedule(ids, p.config).tolist()
    # the tail's host count, read once per problem: the tail never syncs
    n_valid = float(sm.cached(p, "n_valid", lambda: p.n_valid))
    runs, sweep, outputs, fields = lay(states)
    n_kept = states.n_kept.clone()
    dt, k0 = p.data_pad.dtype, runs[0].k
    u_rec = (torch.empty((n_sweeps, C, n_colors, nij, *per), dtype=dt,
                         device=dev) if record_uniforms else None)
    # the field's Philox draws in torch, from the block row of the first
    # state's row 0: the plain sweeps' and gibbs_block's
    draws = None if kernel and mode != "gibbs_block" else {
        "mh": philox.sweep_uniforms, "gibbs": philox.gibbs_sweep_uniforms,
        "gibbs_block": philox.block_sweep_uniforms}[mode]
    metrics.segment_began(sweep0, n_sweeps, dev)
    span.stop()
    for s in range(n_sweeps):
        u = None if uniforms is None else uniforms[s]
        u_out = None if u_rec is None else u_rec[s]
        if draws is not None:
            if u is None:
                u = torch.stack([
                    draws(key, sweep0 + s, n_colors, nij, p.L, device=dev,
                          row0=k0.gy0 * p.nx) for key in k0.keys]).to(dt)
            if u_out is not None:
                u_out.copy_(u)
        sweep(s, sweep0 + s, adapt[s], u, u_out)
        if s == n_sweeps - 1:
            metrics.segment_launched(dev)
        for r in runs:
            r.after(keep[s])
        if keep[s]:
            n_kept = n_kept + 1.0
    span = metrics.span("segment.tail").start()
    accept, dchi, *tail_in = outputs()
    tl = _segment_tail(mode, accept, dchi, *tail_in, states.chi2,
                       states.chi2_comp, n_valid)
    new = fields()
    sum_sq = new.pop("sum_sq")
    result = sm.ChainResult(
        state=sm.SamplerState(
            key=states.key.clone(), chi2=tl.chi2, chi2_comp=tl.chi2_comp,
            n_accept=states.n_accept + tl.n_accept,
            n_propose=states.n_propose + tl.n_propose,
            sum_sq=states.sum_sq.clone() if sum_sq is None else sum_sq,
            n_kept=n_kept, sweep=states.sweep + n_sweeps, **new),
        chi2_trace=tl.chi2_trace, accept_trace=tl.accept_trace,
        flux_trace=tl.flux_trace, monitor_trace=tl.monitor_trace)
    if single:
        result = ch.select_chains(result, 0)
        accept, dchi = accept[:, 0], dchi[:, 0]
        u_rec = None if u_rec is None else u_rec[:, 0]
    span.stop()
    return Segment(result=result, accept=accept, dchi=dchi, uniforms=u_rec)


def _run_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                 uniforms: Optional[torch.Tensor], record_uniforms: bool,
                 mode: str, counter=None,
                 tile: Optional[Tuple[int, int]] = None,
                 classic: bool = False,
                 waves: Optional[List[List[int]]] = None,
                 stages: int = -1, lam_b: Optional[int] = None,
                 rows: Optional[Tuple[int, int]] = None,
                 gy0: int = 0) -> Segment:
    """The segment of every wrapper, on the problem's device
    (:func:`_segment`): ``counter`` None runs the plain sweep, else the
    kernel, adding each launch to ``counter.launches`` (or
    ``counter.resident_launches``); ``tile`` (block rows, columns) runs the
    tiled scan in the order of ``waves`` (None: the raster), None the
    whole-cube one — on the resident kernel where the state fits the
    card's shared memory (``ops/resident.py``) unless ``classic`` pins
    classic K1.  ``stages`` and ``lam_b`` are the kernels' tuning knobs,
    ``rows`` / ``gy0`` a band of the tiled scan (``_SweepState``; the
    per-spaxel outputs of the other rows stay 0)."""
    p = problem

    def lay(states):
        k = sweep_state(p, states, mode, counter is not None, tile, classic,
                        waves, stages, lam_b, rows, gy0)
        order, flat = _monitored(p)
        run = _Running.of(k, states, p, flat, n_sweeps)

        def sweep(s, sweep_abs, adapt, u, u_out):
            _sweep(k, mode, counter, sweep_abs, adapt, u, run.accept[s],
                   run.dchi[s], u_out)

        def outputs():
            return (run.accept, run.dchi, torch.stack(run.flux),
                    torch.stack(run.mon), order)

        def fields():
            return dict(resid=_lambda_first(k.resid[..., :p.L]),
                        clean=_lambda_first(k.clean), log_scale=k.log_scale,
                        sum_clean=_lambda_first(run.sum_clean),
                        sum_sq=None if run.sum_sq is None
                        else _lambda_first(run.sum_sq))
        return [run], sweep, outputs, fields
    return _segment(p, state, n_sweeps, uniforms, record_uniforms, mode,
                    counter is not None, lay)


def _sweep(k: _SweepState, mode: str, counter, sweep: int, adapt: float,
           u: Optional[torch.Tensor], out_a: torch.Tensor,
           out_b: torch.Tensor, u_out: Optional[torch.Tensor]) -> None:
    """One sweep of ``k``: one launch of the kernel of ``mode`` (with
    ``counter``), or its plain sweep, a step per color and tile in the
    order of :func:`_steps`, or ``gibbs_block``'s color by color, its
    draw on the banded kernel or its plain loop."""
    if counter is not None and mode != "gibbs_block":
        _sweep_cuda(k, mode, sweep, adapt, u, out_a, out_b, u_out, counter)
    elif mode == "mh":
        for c, by0, bx0 in _steps(k):
            _mh_step_torch(k, c, by0, bx0, adapt, u, out_a, out_b)
    elif mode == "gibbs":
        for c, by0, bx0 in _steps(k):
            _gibbs_step_torch(k, c, by0, bx0, u, out_a, out_b)
    else:
        sample = (banded.sample_conditional if counter is not None
                  else banded.sample_conditional_reference)
        for c in range(k.f * k.f):
            _block_step(k, c, u, out_a, out_b, sample)


def _use_kernel(problem: sm.Problem, state: sm.SamplerState, name: str) -> bool:
    """False for tensors on the CPU (the plain version), True on one CUDA
    device (the kernel); anything else raises."""
    if problem.device.type == "cpu" and state.resid.device.type == "cpu":
        return False
    if problem.device.type != "cuda" or state.resid.device != problem.device:
        raise ValueError(
            f"{name}: problem on {problem.device}, state on "
            f"{state.resid.device}; the kernel needs both on one CUDA device"
        )
    return True


def mh_segment_reference(problem: sm.Problem, state: sm.SamplerState,
                         n_sweeps: int,
                         uniforms: Optional[torch.Tensor] = None,
                         record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` MH sweeps in plain torch (the kernel's plain version).

    Runs on whatever device the problem lives on.  ``uniforms``
    ``[n_sweeps, (C,) n_colors, nij, L+1]`` replaces the Philox draws.
    """
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="mh")


def mh_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
               uniforms: Optional[torch.Tensor] = None,
               record_uniforms: bool = False, *,
               _classic: bool = False) -> Segment:
    """``n_sweeps`` MH sweeps; each one launch for the whole batch of
    chains: of the resident kernel ``csrc/resident_sweep.cu`` where the
    state fits the card's shared memory (``ops/resident.py``), else of
    classic K1, ``csrc/mh_sweep.cu``.  Both compute the same bits.

    On a CUDA device every sweep goes through a kernel (a failed build or
    launch raises; nothing falls back).  Only for tensors on the CPU does
    it run the plain torch version.  ``mh_segment.launches`` counts classic
    K1's launches, ``mh_segment.resident_launches`` the resident kernel's;
    ``_classic`` pins classic K1 (for the comparisons of the two).
    """
    use = _use_kernel(problem, state, "mh_segment")
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="mh", counter=mh_segment if use else None,
                        classic=_classic)


mh_segment.launches = 0
mh_segment.resident_launches = 0


def gibbs_segment_reference(problem: sm.Problem, state: sm.SamplerState,
                            n_sweeps: int,
                            uniforms: Optional[torch.Tensor] = None,
                            record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` exact-Gibbs sweeps in plain torch (the kernel's plain
    version).  Runs on whatever device the problem lives on.  ``uniforms``
    ``[n_sweeps, (C,) n_colors, nij, 2, L]`` replaces the Philox draws.
    """
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="gibbs")


def gibbs_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                  uniforms: Optional[torch.Tensor] = None,
                  record_uniforms: bool = False, *,
                  _classic: bool = False) -> Segment:
    """``n_sweeps`` exact-Gibbs sweeps; each one launch for the whole batch
    of chains, of the resident kernel or of classic K1
    (``csrc/gibbs_sweep.cu``), as :func:`mh_segment` chooses; counters
    ``gibbs_segment.launches`` and ``gibbs_segment.resident_launches``.
    """
    use = _use_kernel(problem, state, "gibbs_segment")
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="gibbs", counter=gibbs_segment if use else None,
                        classic=_classic)


gibbs_segment.launches = 0
gibbs_segment.resident_launches = 0


def gibbs_block_segment_reference(problem: sm.Problem,
                                  state: sm.SamplerState, n_sweeps: int,
                                  uniforms: Optional[torch.Tensor] = None,
                                  record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` ``gibbs_block`` sweeps in plain torch, the per-color
    draw on the plain banded loops (``ops.banded.
    sample_conditional_reference``), on whatever device the problem lives
    on.  ``uniforms`` ``[n_sweeps, (C,) n_colors, nij, 2, L]`` (the
    Box-Muller pairs) replaces the Philox draws."""
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="gibbs_block")


def gibbs_block_segment(problem: sm.Problem, state: sm.SamplerState,
                        n_sweeps: int,
                        uniforms: Optional[torch.Tensor] = None,
                        record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` ``gibbs_block`` sweeps.  On a CUDA device each color's
    draw is one launch of ``banded_sample_kernel`` (``csrc/banded.cu``)
    for every (chain, spaxel) of the color, counted by
    ``ops.banded.sample_conditional.launches`` (f² per sweep); lin, linT,
    Δχ² and the commits are torch ops, as the JAX package computes them in
    jnp.  Only for tensors on the CPU does the draw run the plain loops."""
    use = _use_kernel(problem, state, "gibbs_block_segment")
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        mode="gibbs_block",
                        counter=gibbs_block_segment if use else None)


#: injected accept decisions closer than this to their threshold
#: (|log u + Δχ²/2|) are moved off it by :func:`untie_uniforms`
TIE_MARGIN = 1e-3


def untie_uniforms(problem: sm.Problem, state: sm.SamplerState,
                   n_sweeps: int, uniforms: torch.Tensor,
                   margin: float = TIE_MARGIN, tries: int = 8,
                   reference=None):
    """Injected MH uniforms with no accept decision within ``margin`` of its
    threshold, and the plain segment they give: ``(uniforms, Segment)``.

    Two float32 evaluations of Δχ² (another summation order, another
    implementation) can disagree on a decision that close, and one flip
    forks the rest of the trajectory.  Each such accept uniform is set
    0.05 inside its own side of the threshold — or, where that side does
    not exist in (0, 1), made a clear accept — and the plain segment
    (``reference``, default :func:`mh_segment_reference`; the tiled scan
    passes its own) is run again until no near-tie is left.
    """
    L = problem.L
    u = uniforms
    reference = reference or mh_segment_reference
    for _ in range(tries):
        seg = reference(problem, state, n_sweeps, u)
        dchi = seg.dchi.double()
        near = (torch.log(u[..., L].double()) + 0.5 * dchi).abs() < margin
        if not bool(near.any()):
            return u, seg
        target = torch.where(seg.accept > 0, -0.5 * dchi - 0.05,
                             -0.5 * dchi + 0.05)
        target = torch.where(target < -1e-6, target, -0.5 * dchi - 0.05)
        new = torch.exp(torch.clamp(target, max=-1e-6)).to(u.dtype)
        u = u.clone()
        u[..., L] = torch.where(near, new, u[..., L])
    raise RuntimeError(f"near-ties left after {tries} passes")
