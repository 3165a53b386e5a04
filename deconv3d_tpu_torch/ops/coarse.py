"""Coarse pattern passes — the spatial mixing accelerator, on torch.

Counterpart of ``deconv3d_tpu/ops/coarse.py``, whose docstring derives the
moves.  Single-site sweeps mix slowly along the directions the FSF blur
nearly annihilates (f-periodic, sign-alternating patterns).  A *pattern
move* applies one shared spectrum jump δ[λ] to an f×f pattern p anchored
on the f-strided block grid, clean[λ, If+a, Jf+b] += δ[λ]·p[a,b]; its model
response R[λ] = Σ_ab p[a,b]·shift_ab(F[λ]) lifts the single-site algebra:
Δχ² = Σ g²·quadR − 2 Σ g·linR with g = LSF(δ).

Modes (``coarse_mode``):

  * ``global`` (the default): one globally coherent f-periodic direction
    per soft pattern, d[y, x] = p[y mod f, x mod f] over the valid field,
    its spectrum drawn exactly from the banded Gaussian conditional
    A = Mᵀ diag(QR) M (``ops/banded.py``): acceptance 1, no tuning.  All
    patterns of a pass read the residual once (phase A), draw in sequence
    with the cross table C (exact, in [L]-vector space), and write it once
    (phase B).
  * ``soft`` / ``block`` / ``mixed``: per-anchor MH moves of the k softest
    eigen-patterns, the all-ones pattern, or both, four checkerboard colors
    per pattern, Gaussian proposals of scale 2.4/√L·quadR^-1/2.

Everything here is plain torch (convolutions, einsums) run under
``convolve.no_tf32`` — cuDNN's TF32 would break the 1e-5 χ² consistency —
except the global pass's banded Cholesky and conditional draws, which on a
CUDA device run the kernels of ``csrc/banded.cu`` (``ops/banded.py``).
Random numbers come from Philox keyed by (chain key, absolute sweep, entry
and pattern or color, stream, anchor) (``ops/philox.py``), so segmented
runs and resumes draw identically; every pass function takes injected
draws in their place for parity tests.  Only anchors whose whole pattern
support is valid move, and the global direction fields are zero on
invalid spaxels, so masked spaxels stay frozen.  Positivity is rejected
by ``sampler.make_problem`` (a shared jump cannot respect it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import convolve as cv
from . import banded as bd
from . import philox
from .sweep import _lsf_band, _lsf_band_T

#: number of soft eigen-patterns used by modes 'soft' and 'global'
N_SOFT = 4

#: the pass families of ``coarse_mode``
MODES = ("soft", "block", "mixed", "global")

#: auto-enable threshold for interleaved global passes (spaxel count); the
#: JAX package measured them as a wall-clock ESS/s win only from here up
COARSE_AUTO_MIN_SPAXELS = 10_000

#: minimum FSF footprint for the auto default: a narrow FSF leaves no slow
#: blur-null modes for the pass to attack
COARSE_AUTO_MIN_F = 9

#: resid bytes above which a pass works in λ-chunks of :data:`CHUNK`
#: planes (the whole-field response is ~5 GB of transients)
CHUNK_ABOVE_BYTES = 2**28
CHUNK = 256

#: the checkerboard colors of the anchor grid, in pass order
COLORS = ((0, 0), (0, 1), (1, 0), (1, 1))


def auto_coarse_every(problem):
    """Data-driven default for ``coarse_every`` (None = stay plain).

    Fires for ``sampler='mh'`` without positivity on fields of at least
    ``COARSE_AUTO_MIN_SPAXELS`` spaxels with footprint ≥
    ``COARSE_AUTO_MIN_F``, where the JAX package measured the passes as a
    wall-clock ESS/s win; gibbs is excluded (a box-flux ESS/s loss there).
    """
    cfg = problem.config
    if (
        cfg.sampler == "mh"
        and not cfg.positivity
        and problem.Y * problem.X >= COARSE_AUTO_MIN_SPAXELS
        and problem.f >= COARSE_AUTO_MIN_F
    ):
        return 8
    return None


def soft_patterns(fsf_np: np.ndarray, k: int = N_SOFT) -> np.ndarray:
    """The k softest f×f patterns of the FSF autocorrelation form
    A[(ab),(a'b')] = Σ_λ (F⋆F)[a−a', b−b'] (≤ 64 planes strided over λ):
    an f²×f² host eigenproblem.  Returns [k, f, f] float64."""
    import scipy.signal

    fsf = np.asarray(fsf_np, np.float64)
    L, f, _ = fsf.shape
    ac = np.zeros((2 * f - 1, 2 * f - 1))
    for l in range(0, L, max(1, L // 64)):
        ac += scipy.signal.correlate2d(fsf[l], fsf[l], mode="full")
    idx = np.arange(f)
    dy = idx[:, None] - idx[None, :]            # a - a'
    A = ac[
        (dy[:, None, :, None] + f - 1),
        (dy[None, :, None, :] + f - 1),
    ].reshape(f * f, f * f)
    _, evecs = np.linalg.eigh(A)
    return evecs[:, :k].T.reshape(k, f, f)


def _patterns(problem, mode: str) -> List[np.ndarray]:
    """Concrete [f, f] float64 patterns for one pass of ``mode``."""
    f = problem.f
    if mode == "block":
        return [np.ones((f, f))]
    if mode == "soft":
        return list(soft_patterns(problem.fsf.cpu().numpy()))
    if mode == "mixed":
        return _patterns(problem, "soft") + _patterns(problem, "block")
    raise ValueError(f"unknown coarse mode {mode!r}")


def batched_field_response(d_stack: torch.Tensor,
                           fsf: torch.Tensor) -> torch.Tensor:
    """R[i,λ,u,v] = Σ_{y,x} d_i[y,x]·F[λ, u−y, v−x] on the padded grid:
    one conv of every direction field [k, Yc, Xc] with the FSF bank →
    [k, L, Hp, Wp]."""
    f = fsf.shape[-1]
    with cv.no_tf32():
        return F.conv2d(d_stack[:, None].to(fsf.dtype),
                        fsf.flip((1, 2))[:, None], padding=f - 1)


def pattern_field_response(d_yx: torch.Tensor,
                           fsf: torch.Tensor) -> torch.Tensor:
    """R_d[λ,u,v] = Σ_{y,x} d[y,x]·F[λ, u−y, v−x] on the padded grid: the
    spaxel-(y, x) patch occupies padded rows [y, y+f), the sampler's
    residual layout."""
    return batched_field_response(d_yx[None], fsf)[0]


def pattern_response(fsf: torch.Tensor, pattern: np.ndarray) -> torch.Tensor:
    """R[λ] = Σ_ab p[a,b]·shift_ab(FSF):  [L, 2f−1, 2f−1]."""
    L, f, _ = fsf.shape
    K = 2 * f - 1
    out = fsf.new_zeros((L, K, K))
    for a in range(f):
        for b in range(f):
            if pattern[a, b] != 0.0:
                out[:, a : a + f, b : b + f] += float(pattern[a, b]) * fsf
    return out


def _depthwise_strided(x: torch.Tensor, k: torch.Tensor,
                       stride: int) -> torch.Tensor:
    """Per-λ VALID correlation of x [L,H,W] with k [L,Ky,Kx] at ``stride``."""
    with cv.no_tf32():
        return F.conv2d(x[None], k[:, None], stride=stride,
                        groups=x.shape[0])[0]


def _expand_anchors(g: torch.Tensor, R: torch.Tensor, B: int, Hp: int,
                    Wp: int) -> torch.Tensor:
    """Σ_{I,J} g[λ,I,J]·R[λ, u−IB, v−JB]  ->  [L, Hp, Wp].

    The transposed stride-B depthwise conv: anchor (I, J)'s response lands
    at (IB, JB); the output is cut or zero-padded to the padded grid.
    """
    L = R.shape[0]
    with cv.no_tf32():
        out = F.conv_transpose2d(g[None], R[:, None], stride=B, groups=L)[0]
    out = F.pad(out, (0, Wp - out.shape[2], 0, Hp - out.shape[1]))
    assert out.shape == (L, Hp, Wp), (out.shape, Hp, Wp)
    return out


def global_constants(problem):
    """mode='global': stacked direction fields, the per-pattern precision
    diagonals QR[i, λ] = Σ_uv R_i²w, their banded Cholesky factors and the
    cross table C[i,j,λ] = Σ_uv R_i·R_j·w — built once per run.

    Committing a draw along direction i shifts every other direction's
    linear term by exactly −g_i·C[i, j] (the commit is linear in the
    residual), so a pass's sequential draws need no residual re-read.
    Patterns whose response norm vanishes at some λ (fully masked planes:
    an improper conditional) are dropped.  λ-chunked on huge fields.  The
    factors come from one batched launch of the Cholesky kernel on a CUDA
    device.  Returns ``[("global_batch", d_stack, QR, chols, C)]``, or
    ``[]`` when every pattern is dropped.
    """
    p = problem
    fsf = p.fsf
    dtype, dev = fsf.dtype, fsf.device
    validf = p.valid.to(dtype)
    d_stack = torch.stack([
        torch.as_tensor(pat, dtype=dtype, device=dev).tile(p.ny, p.nx)
        * validf
        for pat in soft_patterns(fsf.cpu().numpy())
    ])
    chunk = CHUNK if p.w_pad.nbytes > CHUNK_ABOVE_BYTES else p.L
    C_parts = []
    for lo in range(0, p.L, chunk):
        R_c = batched_field_response(d_stack, fsf[lo : lo + chunk])
        w_c = p.w_pad[lo : lo + chunk]
        with cv.no_tf32():
            C_parts.append(torch.einsum("iluv,jluv->ijl", R_c,
                                        R_c * w_c[None]))
        del R_c
    C = torch.cat(C_parts, dim=2)                    # [k, k, L]
    QR = torch.diagonal(C, dim1=0, dim2=1).T         # [k, L]
    keep = [i for i in range(d_stack.shape[0]) if float(QR[i].min()) > 0.0]
    if not keep:
        return []
    keep_t = torch.as_tensor(keep, device=dev)
    d_stack = d_stack[keep_t].contiguous()
    QR = QR[keep_t].contiguous()
    C = C[keep_t][:, keep_t].contiguous()
    chols = bd.cholesky_banded(bd.precision_bands(p.lsf, QR))
    return [("global_batch", d_stack, QR, chols, C)]


def _kahan(chi2: torch.Tensor, chi2c: torch.Tensor, dchi: torch.Tensor):
    """(chi2 + dchi, compensation) in float32, as the sweeps keep χ²."""
    y = dchi - chi2c
    t = chi2 + y
    return t, (t - chi2) - y


def _global_pass_batch(problem, state, d_stack, QR, chols, C, noise,
                       chunk: int):
    """One pass of exact hit-and-run Gibbs draws along all global
    directions: δ_i ~ N(A_i⁻¹ Mᵀ LR_i, A_i⁻¹), A_i = Mᵀ diag(QR_i) M, drawn
    in sequence, each conditional on the previous commits.

    Phase A reads the residual once (LR[i, λ] = Σ_uv R_i·resid·w, one
    batched response conv per λ-chunk); the draws update the linear terms
    through C (LR_j ← LR_j − g_i·C[i,j]); phase B writes the summed commit
    Σ_i g_i·R_i once.  ``noise`` [k, L]: the standard normals of the draws.
    Returns a new state (the input's tensors are not written); n_accept and
    n_propose both grow by k·L, as in the JAX package.
    """
    p = problem
    L, k = p.L, d_stack.shape[0]
    fsf, w = p.fsf, p.w_pad
    resid, clean = state.resid.clone(), state.clean.clone()

    LR = resid.new_empty((k, L))
    for lo in range(0, L, chunk):
        hi = min(L, lo + chunk)
        R_c = batched_field_response(d_stack, fsf[lo:hi])
        with cv.no_tf32():
            LR[:, lo:hi] = torch.einsum("kluv,luv->kl", R_c,
                                        resid[lo:hi] * w[lo:hi])
        del R_c

    G, D = resid.new_empty((k, L)), resid.new_empty((k, L))
    dchi_tot = torch.zeros((), dtype=torch.float32, device=resid.device)
    for i in range(k):
        b = _lsf_band_T(LR[i], p.lsf)
        delta = bd.sample_conditional(chols[i], b.contiguous(),
                                      noise[i].contiguous())
        g = _lsf_band(delta, p.lsf)
        dchi_tot = dchi_tot + torch.sum(g * g * QR[i] - 2.0 * g * LR[i],
                                        dtype=torch.float32)
        if i + 1 < k:
            LR = LR - g[None] * C[i]       # rows ≤ i already consumed
        G[i], D[i] = g, delta

    for lo in range(0, L, chunk):
        hi = min(L, lo + chunk)
        R_c = batched_field_response(d_stack, fsf[lo:hi])
        with cv.no_tf32():
            resid[lo:hi] -= torch.einsum("kl,kluv->luv", G[:, lo:hi], R_c)
            clean[lo:hi] += torch.einsum("kl,kyx->lyx", D[:, lo:hi],
                                         d_stack).to(clean.dtype)
        del R_c

    chi2, chi2c = _kahan(state.chi2, state.chi2_comp, dchi_tot)
    return dataclasses.replace(
        state, resid=resid, clean=clean, chi2=chi2, chi2_comp=chi2c,
        n_accept=state.n_accept + k * L, n_propose=state.n_propose + k * L,
    )


def coarse_constants(problem, mode: str = "soft"):
    """Per-pattern constants of ``mode`` — built once per run.  'global':
    :func:`global_constants`; else one ``("anchor", pattern, R, quadR,
    validR)`` per pattern, where only anchors whose full pattern support is
    valid (and whose response sees weight) move: a shared jump would drag
    frozen spaxels — masked, or the off-grid padding — off zero."""
    if mode == "global":
        return global_constants(problem)
    p = problem
    valid = p.valid.cpu().numpy()
    dtype, dev = p.fsf.dtype, p.fsf.device
    out = []
    for pat in _patterns(problem, mode):
        R = pattern_response(p.fsf, pat)
        quad_r = _depthwise_strided(p.w_pad, R * R, p.f)[:, : p.ny, : p.nx]
        ok = np.ones((p.ny, p.nx), bool)
        for a, b in np.argwhere(pat != 0.0):
            ok &= valid[a :: p.f, b :: p.f][: p.ny, : p.nx]
        ok &= (quad_r.sum(dim=0) > 0).cpu().numpy()
        valid_r = torch.as_tensor(ok, dtype=dtype, device=dev)
        out.append(("anchor", torch.as_tensor(pat, dtype=dtype, device=dev),
                    R, quad_r, valid_r))
    return out


def _pattern_pass(problem, state, pat, R, quad_r, valid_r, normals,
                  uniforms, scale_mult: float):
    """The 4 checkerboard colors of one pattern's MH updates.

    ``normals`` [4, L, ny, nx] and ``uniforms`` [4, ny, nx]: each color's
    Gaussian proposal draws and accept uniforms.  Returns a new state."""
    p = problem
    L, ny, nx, B = p.L, p.ny, p.nx, p.f
    resid, clean = state.resid, state.clean
    chi2, chi2c = state.chi2, state.chi2_comp
    acc_tot, prop_tot = state.n_accept, state.n_propose
    w = p.w_pad
    # fixed near-optimal per-λ scales from the (constant) pattern precision
    sigma = torch.rsqrt(torch.clamp(quad_r, min=1e-20))
    scale = float(scale_mult / np.sqrt(L)) * sigma
    for c, (oy, ox) in enumerate(COLORS):
        sel = torch.zeros((ny, nx), dtype=resid.dtype, device=resid.device)
        sel[oy::2, ox::2] = 1.0
        live = sel * valid_r
        jumps = scale * normals[c].to(resid.dtype) * live[None]
        g = _lsf_band(jumps.movedim(0, -1), p.lsf).movedim(-1, 0)
        lin = _depthwise_strided(resid * w, R, B)[:, :ny, :nx]
        with cv.no_tf32():
            dchi = (torch.einsum("lij,lij->ij", g * g, quad_r)
                    - 2.0 * torch.einsum("lij,lij->ij", g, lin))
        logu = torch.log(uniforms[c].to(resid.dtype))
        accept = (logu < -0.5 * dchi) & (live > 0)
        accf = accept.to(resid.dtype)
        resid = resid - _expand_anchors(g * accf[None], R, B, p.Hp, p.Wp)
        # clean[λ, If+a, Jf+b] += δ_acc[λ,I,J]·p[a,b] on the block view
        jacc = jumps * accf[None]
        clean = (
            clean.reshape(L, ny, B, nx, B)
            + jacc[:, :, None, :, None] * pat[None, None, :, None, :]
        ).reshape(L, ny * B, nx * B)
        dchi_acc = torch.sum(torch.where(accept, dchi, torch.zeros_like(dchi)),
                             dtype=torch.float32)
        chi2, chi2c = _kahan(chi2, chi2c, dchi_acc)
        acc_tot = acc_tot + torch.sum(accf, dtype=torch.float32)
        prop_tot = prop_tot + torch.sum(live, dtype=torch.float32)
    return dataclasses.replace(
        state, resid=resid, clean=clean, chi2=chi2, chi2_comp=chi2c,
        n_accept=acc_tot, n_propose=prop_tot,
    )


def pass_draws(problem, state, constants):
    """The Philox draws of one pass of ``constants`` on one chain's
    ``state`` (its key, its absolute sweep): per entry, the global pass's
    normals [k, L], or an anchor entry's (normals [4, L, ny, nx], accept
    uniforms [4, ny, nx])."""
    p = problem
    key = int(state.key) & 0xFFFFFFFFFFFFFFFF
    sweep, dev = int(state.sweep), state.resid.device
    nij = p.ny * p.nx
    out = []
    for e, entry in enumerate(constants):
        if entry[0] == "global_batch":
            slots = [philox.pass_slot(e, i) for i in range(entry[1].shape[0])]
            out.append(philox.pass_normals(key, sweep, slots, 1, p.L,
                                           dev)[:, 0])
        else:
            slots = [philox.pass_slot(e, c) for c in range(len(COLORS))]
            normals = philox.pass_normals(key, sweep, slots, nij, p.L, dev)
            out.append((
                normals.reshape(len(COLORS), p.ny, p.nx, p.L).movedim(-1, 1),
                philox.pass_accept_uniforms(key, sweep, slots, nij,
                                            dev).reshape(-1, p.ny, p.nx),
            ))
    return out


def coarse_pass(problem, state, constants, scale_mult: float = 2.4,
                draws: Optional[Sequence] = None):
    """One coarse pass of one chain: every entry of ``constants``
    (:func:`coarse_constants`) in sequence — exact Gibbs draws along the
    global directions, or valid MH kernels per anchor — so the posterior
    is invariant.  ``draws`` (one per entry, as :func:`pass_draws` makes
    them) replaces the Philox draws.  Returns a new state."""
    if draws is None:
        draws = pass_draws(problem, state, constants)
    dtype = state.resid.dtype
    chunk = CHUNK if state.resid.nbytes > CHUNK_ABOVE_BYTES else problem.L
    for entry, drawn in zip(constants, draws):
        if entry[0] == "global_batch":
            _, d_stack, QR, chols, C = entry
            state = _global_pass_batch(
                problem, state, d_stack, QR, chols, C, drawn.to(dtype),
                chunk=chunk)
        else:
            _, pat, R, quad_r, valid_r = entry
            normals, uniforms = drawn
            state = _pattern_pass(problem, state, pat, R, quad_r, valid_r,
                                  normals, uniforms, float(scale_mult))
    return state
