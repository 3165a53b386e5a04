"""MH sweep segments: the CUDA kernel's wrapper and its plain torch version.

Counterpart of ``deconv3d_tpu/ops/pallas_sweep.py`` (mode ``'mh'``, one
chain).  :func:`mh_segment` runs each sweep through the hand-written kernel
``csrc/mh_sweep.cu`` when the problem lives on a CUDA device, and takes
:func:`mh_segment_reference` — the same sweep in plain torch — only for
tensors on the CPU.  Both share everything around the sweep:

  * the λ-contiguous segment layout (``[Hp, Wp, L]`` residual and weights,
    ``[Yc, Xc, L]`` clean and quad), set up at the segment start and undone
    at its end;
  * per-(sweep, color, spaxel) outputs — the accept flag and the proposed
    Δχ² — summed in a fixed order (float64) into the per-sweep Kahan χ²
    update, as ``_assemble`` does in the JAX package;
  * the posterior accumulators, flux and monitor traces as plain torch ops
    after every sweep.

Random numbers come from Philox keyed by (chain key, ABSOLUTE sweep, color,
spaxel row, λ, stream) (``ops/philox.py``), so segmentation and resume are
bit-exact.  For parity tests both functions take ``uniforms``
``[n_sweeps, n_colors, nij, L + 1]`` (the L jump uniforms and the accept
uniform of every decision) in place of the generator.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import sampler as sm
from . import philox


@dataclasses.dataclass
class Segment:
    """A segment's ChainResult plus its per-decision outputs."""

    result: sm.ChainResult
    accept: torch.Tensor            # [n_sweeps, n_colors, nij] 1.0 / 0.0
    dchi: torch.Tensor              # [n_sweeps, n_colors, nij] proposed Δχ²
    uniforms: Optional[torch.Tensor] = None   # [n_sweeps, n_colors, nij, L+1]


@dataclasses.dataclass
class _SweepState:
    """Segment-layout tensors one sweep reads and updates in place."""

    resid: torch.Tensor      # [Hp, Wp, L]
    w: torch.Tensor          # [Hp, Wp, L]
    quad: torch.Tensor       # [Yc, Xc, L]
    clean: torch.Tensor      # [Yc, Xc, L]
    log_scale: torch.Tensor  # [Yc, Xc]
    valid: torch.Tensor      # [Yc, Xc] float 1/0
    spec: torch.Tensor       # [S, L]
    imgs: torch.Tensor       # [S, f, f]
    lsf: torch.Tensor        # [L, lw]
    f: int
    ny: int
    nx: int
    key: int
    target: float
    scratch: Optional[torch.Tensor] = None   # kernel workspace, reused


def _lambda_last(t: torch.Tensor) -> torch.Tensor:
    """[L, A, B] → contiguous [A, B, L]."""
    return t.permute(1, 2, 0).contiguous()


def _lambda_first(t: torch.Tensor) -> torch.Tensor:
    """[A, B, L] → contiguous [L, A, B]."""
    return t.permute(2, 0, 1).contiguous()


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


def _sweep_torch(k: _SweepState, adapt: float, u: torch.Tensor,
                 accept_out: torch.Tensor, dchi_out: torch.Tensor) -> None:
    """One MH sweep over all f² colors with the uniforms ``u``
    ``[n_colors, nij, L+1]``; updates ``k`` in place."""
    f, ny, nx = k.f, k.ny, k.nx
    L = k.spec.shape[1]
    BY, BX = ny * f, nx * f
    pi = torch.tensor(math.pi, dtype=k.resid.dtype)
    cells = lambda t: t.view(ny, f, nx, f, *t.shape[2:])  # noqa: E731
    for c in range(f * f):
        cy, cx = divmod(c, f)
        rblk = k.resid[cy : cy + BY, cx : cx + BX].view(ny, f, nx, f, L)
        wblk = k.w[cy : cy + BY, cx : cx + BX].view(ny, f, nx, f, L)
        pooled = torch.einsum("sab,iajbl->sijl", k.imgs, rblk * wblk)
        lin = (k.spec[:, None, None, :] * pooled).sum(dim=0)     # [ny,nx,L]

        v = cells(k.valid)[:, cy, :, cx]                          # [ny,nx]
        ls = cells(k.log_scale)[:, cy, :, cx]                     # view
        q = cells(k.quad)[:, cy, :, cx]                           # [ny,nx,L]
        uc = u[c].view(ny, nx, L + 1)
        draw = torch.clamp(torch.tan(pi * (uc[..., :L] - 0.5)), -1e3, 1e3)
        jumps = torch.exp(ls)[..., None] * draw * v[..., None]
        g = _lsf_band(jumps, k.lsf)
        dchi = (g * g * q - 2.0 * g * lin).sum(dim=-1)            # [ny,nx]
        accf = ((torch.log(uc[..., L]) < -0.5 * dchi) & (v > 0)).to(g.dtype)

        gacc = g * accf[..., None]
        delta = torch.zeros_like(rblk)
        for s in range(k.spec.shape[0]):
            gs = k.spec[s] * gacc                                  # [ny,nx,L]
            delta = delta + gs[:, None, :, None, :] * k.imgs[s][None, :, None, :, None]
        rblk -= delta
        cells(k.clean)[:, cy, :, cx] += jumps * accf[..., None]
        ls += adapt * (accf - k.target) * v
        accept_out[c] = accf.reshape(-1)
        dchi_out[c] = dchi.reshape(-1)


# ---------------------------------------------------------------------------
# One sweep: the CUDA kernel
# ---------------------------------------------------------------------------

def _check_cuda(name: str, t: torch.Tensor, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sweep_cuda(k: _SweepState, sweep: int, adapt: float,
                u: Optional[torch.Tensor], accept_out: torch.Tensor,
                dchi_out: torch.Tensor,
                u_out: Optional[torch.Tensor] = None) -> None:
    """Launch ``csrc/mh_sweep.cu`` for one sweep on the current stream."""
    from .._build import load_library

    import ctypes

    dev = k.resid.device
    f, ny, nx = k.f, k.ny, k.nx
    S, L = k.spec.shape
    nij, n_colors = ny * nx, f * f
    Hp, Wp = f - 1 + ny * f, f - 1 + nx * f
    shapes = {
        "resid": (k.resid, (Hp, Wp, L)), "w": (k.w, (Hp, Wp, L)),
        "quad": (k.quad, (ny * f, nx * f, L)),
        "clean": (k.clean, (ny * f, nx * f, L)),
        "log_scale": (k.log_scale, (ny * f, nx * f)),
        "valid": (k.valid, (ny * f, nx * f)),
        "spec": (k.spec, (S, L)), "imgs": (k.imgs, (S, f, f)),
        "lsf": (k.lsf, (L, k.lsf.shape[1])),
        "accept_out": (accept_out, (n_colors, nij)),
        "dchi_out": (dchi_out, (n_colors, nij)),
    }
    if u is not None:
        shapes["uniforms"] = (u, (n_colors, nij, L + 1))
    if u_out is not None:
        shapes["uniforms_out"] = (u_out, (n_colors, nij, L + 1))
    for name, (t, shape) in shapes.items():
        _check_cuda(name, t, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not 1 <= S <= 8:
        raise ValueError(f"the kernel takes FSF rank 1..8, got {S}")

    lib = load_library()
    n_scratch = lib.mh_sweep_scratch_floats(L, ny, nx)
    if k.scratch is None or k.scratch.numel() < n_scratch:
        k.scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    k0, k1 = philox.key_words(k.key)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mh_sweep_launch(
            ptr(k.resid), ptr(k.w), ptr(k.quad), ptr(k.clean),
            ptr(k.log_scale), ptr(k.valid), ptr(k.spec), ptr(k.imgs),
            ptr(k.lsf), ptr(u), ptr(accept_out), ptr(dchi_out), ptr(u_out),
            ptr(k.scratch), L, f, ny, nx, S, int(k.lsf.shape[1]), k0, k1,
            sweep & philox.M32, adapt, k.target, ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"mh_sweep_launch failed: CUDA error {err}")
    mh_segment.launches += 1


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

def _run_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
                 uniforms: Optional[torch.Tensor], record_uniforms: bool,
                 use_kernel: bool) -> Segment:
    p, cfg = problem, problem.config
    dev = p.device
    f, ny, nx, L = p.f, p.ny, p.nx, p.L
    n_colors, nij = p.n_colors, ny * nx
    if uniforms is not None and tuple(uniforms.shape) != (
        n_sweeps, n_colors, nij, L + 1
    ):
        raise ValueError(
            f"uniforms must be [{n_sweeps}, {n_colors}, {nij}, {L + 1}], got "
            f"{tuple(uniforms.shape)}"
        )
    # the kernel is float32-only (_sweep_cuda checks); the plain version
    # runs in the problem's dtype, float64 included
    dt, f32 = p.data_pad.dtype, torch.float32
    k = _SweepState(
        resid=_lambda_last(state.resid.to(dt)),
        w=_lambda_last(p.w_pad),
        quad=_lambda_last(p.quad),
        clean=_lambda_last(state.clean.to(dt)),
        log_scale=state.log_scale.to(dt).clone(),
        valid=p.valid.to(dt).contiguous(),
        spec=p.fsf_spec.contiguous(),
        imgs=p.fsf_imgs.contiguous(),
        lsf=p.lsf.contiguous(),
        f=f, ny=ny, nx=nx, key=int(state.key), target=float(cfg.target_acceptance),
    )
    sweep0 = int(state.sweep)
    ids = sweep0 + torch.arange(n_sweeps, dtype=torch.int64)
    adapt = sm.adapt_schedule(ids, cfg).tolist()
    keep = sm.keep_schedule(ids, cfg).tolist()

    validf = k.valid[..., None]
    Yc, Xc = p.Yc, p.Xc
    mon = p.monitor_idx
    mon_t = ((mon % (Yc * Xc)) * L + mon // (Yc * Xc)).to(dev)
    sum_clean = _lambda_last(state.sum_clean.to(dt))
    sum_sq = (
        _lambda_last(state.sum_sq.to(dt)) if cfg.track_variance
        else state.sum_sq.clone()
    )
    chi2, chi2c = state.chi2.clone(), state.chi2_comp.clone()
    n_kept = float(state.n_kept)

    accept = torch.empty((n_sweeps, n_colors, nij), dtype=dt, device=dev)
    dchi = torch.empty((n_sweeps, n_colors, nij), dtype=dt, device=dev)
    u_rec = (
        torch.empty((n_sweeps, n_colors, nij, L + 1), dtype=dt, device=dev)
        if record_uniforms else None
    )
    chi2_t, flux_t, mon_tr = [], [], []
    for s in range(n_sweeps):
        u = None if uniforms is None else uniforms[s]
        if use_kernel:
            _sweep_cuda(k, sweep0 + s, adapt[s], u, accept[s], dchi[s],
                        None if u_rec is None else u_rec[s])
        else:
            if u is None:
                u = philox.sweep_uniforms(k.key, sweep0 + s, n_colors, nij, L,
                                          device=dev).to(dt)
            if u_rec is not None:
                u_rec[s] = u
            _sweep_torch(k, adapt[s], u, accept[s], dchi[s])
        # accepted Δχ² summed in a fixed order, then the Kahan update
        dchi_sweep = (dchi[s].double() * accept[s].double()).sum().to(f32)
        y = dchi_sweep - chi2c
        t = chi2 + y
        chi2c = (t - chi2) - y
        chi2 = t
        if keep[s]:
            sum_clean += k.clean
            if cfg.track_variance:
                sum_sq += k.clean * k.clean
            n_kept += 1.0
        chi2_t.append(chi2)
        flux_t.append(torch.sum(k.clean * validf, dtype=f32))
        mon_tr.append(k.clean.reshape(-1)[mon_t])

    n_valid = float(p.valid.sum())
    acc_sweep = accept.sum(dim=(1, 2))
    new_state = sm.SamplerState(
        clean=_lambda_first(k.clean),
        resid=_lambda_first(k.resid),
        key=state.key.clone(),
        chi2=chi2,
        chi2_comp=chi2c,
        log_scale=k.log_scale,
        n_accept=state.n_accept + acc_sweep.sum(),
        n_propose=state.n_propose + float(n_sweeps) * n_valid,
        sum_clean=_lambda_first(sum_clean),
        sum_sq=_lambda_first(sum_sq) if cfg.track_variance else sum_sq,
        n_kept=torch.tensor(n_kept, dtype=f32, device=dev),
        sweep=state.sweep + n_sweeps,
    )
    result = sm.ChainResult(
        state=new_state,
        chi2_trace=torch.stack(chi2_t) if chi2_t else chi2[None][:0],
        accept_trace=acc_sweep / max(n_valid, 1.0),
        flux_trace=torch.stack(flux_t) if flux_t else chi2[None][:0],
        monitor_trace=(
            torch.stack(mon_tr) if mon_tr
            else torch.empty((0, mon.numel()), dtype=dt, device=dev)
        ),
    )
    return Segment(result=result, accept=accept, dchi=dchi, uniforms=u_rec)


def mh_segment_reference(problem: sm.Problem, state: sm.SamplerState,
                         n_sweeps: int,
                         uniforms: Optional[torch.Tensor] = None,
                         record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` MH sweeps in plain torch (the kernel's plain version).

    Runs on whatever device the problem lives on.  ``uniforms``
    ``[n_sweeps, n_colors, nij, L+1]`` replaces the Philox draws.
    """
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        use_kernel=False)


#: injected accept decisions closer than this to their threshold
#: (|log u + Δχ²/2|) are moved off it by :func:`untie_uniforms`
TIE_MARGIN = 1e-3


def untie_uniforms(problem: sm.Problem, state: sm.SamplerState,
                   n_sweeps: int, uniforms: torch.Tensor,
                   margin: float = TIE_MARGIN, tries: int = 8):
    """Injected uniforms with no accept decision within ``margin`` of its
    threshold, and the plain segment they give: ``(uniforms, Segment)``.

    Two float32 evaluations of Δχ² (another summation order, another
    implementation) can disagree on a decision that close, and one flip
    forks the rest of the trajectory.  Each such accept uniform is set
    0.05 inside its own side of the threshold — or, where that side does
    not exist in (0, 1), made a clear accept — and the plain segment is
    run again until no near-tie is left.
    """
    L = problem.L
    u = uniforms
    for _ in range(tries):
        seg = mh_segment_reference(problem, state, n_sweeps, u)
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


def mh_segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
               uniforms: Optional[torch.Tensor] = None,
               record_uniforms: bool = False) -> Segment:
    """``n_sweeps`` MH sweeps; each one launch of ``csrc/mh_sweep.cu``.

    On a CUDA device every sweep goes through the kernel (a failed build
    or launch raises).  Only for tensors on the CPU does it run the plain
    torch version.  ``mh_segment.launches`` counts kernel launches.
    """
    if problem.device.type == "cpu" and state.resid.device.type == "cpu":
        return mh_segment_reference(problem, state, n_sweeps, uniforms,
                                    record_uniforms)
    if problem.device.type != "cuda" or state.resid.device != problem.device:
        raise ValueError(
            f"mh_segment: problem on {problem.device}, state on "
            f"{state.resid.device}; the kernel needs both on one CUDA device"
        )
    return _run_segment(problem, state, n_sweeps, uniforms, record_uniforms,
                        use_kernel=True)


mh_segment.launches = 0
