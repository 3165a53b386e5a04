"""Spatially-sharded direct sampler and MAP: ONE solve spans a mesh's slots.

Counterpart of ``deconv3d_tpu/parallel/direct_sharded.py``.  The JAX
package's version is global-view: it jits the unchanged
``direct_run_sweeps`` over Y-sharded leaves and lets GSPMD insert the halo
exchanges, the reshards around the spatial FFTs and the psums.  PyTorch
has no partitioner, so here the PCG of ``ops/direct.py`` is sharded by
hand, on the slots of a ``parallel.Mesh`` axis:

  * Layout.  Every CG vector ``[L, Y, X]`` is cut along Y into D row
    blocks (``torch.tensor_split``: uneven blocks allowed), block d on
    slot d, a sharded vector being the list of the slots' tensors.  Each
    slot holds its rows of the interior weights, data and free mask
    (:class:`Shards`, built once per problem and mesh axis).
  * The operator A = P (KᵀWK + τI) P.  The LSF stage is local: a slot
    holds every λ of its spaxels.  The FSF stage is a 'same' convolution
    of reach h = f//2 rows: each slot assembles the slab of rows
    [y0 − h, y1 + h) from whichever slots own them (a shard may be thinner
    than h), zeros past the field's edges, convolves it (FFT with the
    bank's spectrum at the slab's size, or the grouped conv) and keeps its
    own rows.
  * The preconditioner M⁻¹.  Its rfft2 is the FFT over Y of the rfft over
    X: each slot takes the rfft over X of its rows, a ragged all-to-all
    (``mesh.all_to_all_ragged``) hands slot e the kx columns [kx0, kx1) of
    every row, the FFT over Y runs there, and ONE launch of the banded
    solve kernel (``ops/banded.py::banded_solve``) per slot solves the
    slot's columns against the factors, which every slot holds whole;
    then back the same way.  ``'jacobi'`` is elementwise and local.
  * PCG is ``ops/direct.py::pcg`` itself with :class:`ShardOps`: dots and
    norms are per-slot partial sums added in slot order on the first slot
    (``mesh.slot_sum``, the order of ``mesh.psum``).  The MAP keeps
    ``posterior_mean``'s float64 refinement, on float64 copies of the slot
    constants.
  * Draws.  Each slot builds its rows of the right-hand side from its rows
    of the whole cube's Philox normals (``philox.cube_normals`` with
    ``rows``), so a sharded chain draws the numbers of an unsharded one.
    The state enters and leaves each segment whole on the problem's
    device; only the CG vectors and the FFT transients are sharded.
  * Ranks.  The slots may belong to several ranks
    (``parallel/multihost.py``'s global mesh, as the JAX package's GSPMD
    program runs over a global mesh): a rank holds and computes its own
    slots' blocks only (the others' entries are None), the slabs' halo
    rows, the all-to-alls and the gathers cross the ranks
    (``mesh.route``), each rank launches the solve once per slot of its
    own, and the dots are the slots' partial dots added in slot order on
    every rank, so the ranks iterate alike and end bit-equal to the
    one-process mesh.

Not ported: ``_PROGRAM_CACHE``, ``_placed`` and ``_out_shardings`` (jit
and GSPMD machinery).  Where Y does not divide by D the JAX package
replicates the leaf; the uneven blocks here compute the same thing and
keep the memory sharded.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convolve as cv
from .. import sampler as sm
from ..ops import banded, philox
from ..ops import direct as _dr
from . import mesh as pm
from .mesh import Mesh, all_to_all_ragged, slot_sum


def _axis(mesh: Mesh, axis_name: Optional[str]
          ) -> Tuple[str, List[torch.device]]:
    """(axis name, its slots); on a 2-D mesh the first row of the axis."""
    if axis_name is None:
        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"pass axis_name for multi-axis mesh {mesh.axis_names}")
        axis_name = mesh.axis_names[0]
    return axis_name, mesh.rows(axis_name)[0]


def _cut(n: int, d: int) -> List[Tuple[int, int]]:
    """(start, stop) of the ``d`` blocks of ``torch.tensor_split`` over
    ``n``: the first n % d blocks one longer."""
    sizes = [len(t) for t in torch.tensor_split(torch.arange(n), d)]
    return [(int(b - k), int(b)) for k, b in zip(sizes, np.cumsum(sizes))]


def _each(fn, *vecs):
    """``fn`` slot by slot over sharded vectors: None where this process
    holds no part."""
    return [None if args[0] is None else fn(*args) for args in zip(*vecs)]


class ShardOps(_dr.VectorOps):
    """``pcg``'s vector operations on sharded vectors: part by part; a dot
    is the slots' partial dots added in slot order (``ranks``: the slots'
    owners; across ranks every rank adds the same parts in that order)."""

    def __init__(self, ranks=None):
        self.ranks = ranks

    def map(self, fn, *vecs):
        return _each(fn, *vecs)

    def dot(self, a, b) -> torch.Tensor:
        return slot_sum(_each(lambda x, y: torch.dot(x.reshape(-1),
                                                     y.reshape(-1)), a, b),
                        self.ranks)

    def norm(self, a) -> float:
        return float(torch.sqrt(self.dot(a, a)))

    def dot_norm(self, a, b):
        """(a·b, ‖a‖) from one slot-order sum of the slots' [a·b, a·a]."""
        both = slot_sum(_each(lambda x, y: torch.stack([
            torch.dot(x.reshape(-1), y.reshape(-1)),
            torch.dot(x.reshape(-1), x.reshape(-1))]), a, b), self.ranks)
        return both[0], float(torch.sqrt(both[1]))

    def axpy(self, y, s, v, value: float = 1.0):
        return _each(lambda y_, v_: y_.addcmul_(v_, s.to(y_.device),
                                                value=value), y, v)


SHARDED = ShardOps()


class Shards:
    """One problem's constants on the slots of a mesh axis: the row blocks
    and kx column blocks, each slot's rows of the interior weights ``w``,
    data ``d`` and free mask ``free``, and the LSF on every slot device.
    Holds no reference to the problem (it is cached on it): the operators
    take it, for the FSF's bank and spectra (``ops/direct.py::_fsf``,
    cached there by slab height and device)."""

    def __init__(self, problem, devices: Sequence[torch.device]):
        p = problem
        D = len(devices)
        if p.Y < D:
            raise ValueError(f"{p.Y} spaxel rows cannot be cut into {D} "
                             "row blocks")
        self.devices = list(devices)
        # the slots' owners: this process's slots only are built here
        self.ranks = getattr(devices, "ranks", (pm.process_rank(),) * D)
        self.mine = [r == pm.process_rank() for r in self.ranks]
        self.ops = ShardOps(self.ranks)
        self.L, self.Y, self.X = p.L, p.Y, p.X
        self.h = p.f // 2
        self.dtype = p.data_pad.dtype
        self.rows = _cut(p.Y, D)
        self.cols = _cut(p.X // 2 + 1, D)
        w, d, free = _dr._w_in(p), _dr._d_in(p), _dr._free_mask(p)
        self.w, self.d, self.free = self.cut(w), self.cut(d), self.cut(free)
        mat = _dr._lsf_matrix(p)
        self.lsf, self.lsf_mat = {}, {}
        for dev in {d_ for d_, m in zip(self.devices, self.mine) if m}:
            self.lsf[dev] = p.lsf.to(dev)
            self.lsf_mat[dev] = None if mat is None else mat.to(dev)
        # slab d: rows [y0 − h, y1 + h) = top zeros, pieces (slot, a, b)
        # of the owners' blocks, bottom zeros
        self.plan = []
        for y0, y1 in self.rows:
            lo, hi = y0 - self.h, y1 + self.h
            pieces = [(e, max(lo, a) - a, min(hi, b) - a)
                      for e, (a, b) in enumerate(self.rows)
                      if max(lo, a) < min(hi, b)]
            self.plan.append((max(0, -lo), max(0, hi - p.Y), pieces))

    # -- layout --------------------------------------------------------------

    def cut(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` ``[..., Y, X]`` cut into this process's slots' row blocks
        (copies on their devices; None for the slots of other ranks)."""
        return [x[..., a:b, :].to(dev, copy=True) if m else None
                for (a, b), dev, m in zip(self.rows, self.devices,
                                          self.mine)]

    def gather(self, parts: Sequence[torch.Tensor], device) -> torch.Tensor:
        """The slots' row blocks joined on ``device`` (on every rank)."""
        return pm.gather(parts, device, -2, self.ranks)

    def slabs(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per slot of this process, rows [y0 − h, y1 + h) of the sharded
        ``parts``, from whichever slots (and ranks) own them; zeros past
        the field's edges."""
        me = pm.process_rank()
        if all(self.mine):
            got = {(e, d): parts[e][:, a:b].to(parts[d].device)
                   for d, (_, _, pieces) in enumerate(self.plan)
                   for e, a, b in pieces}
        else:
            got = pm.route([
                (e, d, parts[e][:, a:b] if self.mine[e] else None,
                 ((parts[d].shape[0], b - a, parts[d].shape[2]),
                  parts[d].dtype, parts[d].device) if self.mine[d] else None)
                for d, (_, _, pieces) in enumerate(self.plan)
                for e, a, b in pieces
                if e != d and me in (self.ranks[e], self.ranks[d])],
                self.ranks)
        out = []
        for d, (top, bottom, pieces) in enumerate(self.plan):
            x = parts[d]
            if x is None:
                out.append(None)
                continue
            seq = [x[:, a:b] if e == d else got[e, d] for e, a, b in pieces]
            if top:
                seq.insert(0, x.new_zeros((x.shape[0], top, x.shape[2])))
            if bottom:
                seq.append(x.new_zeros((x.shape[0], bottom, x.shape[2])))
            out.append(torch.cat(seq, dim=1))
        return out

    # -- operators -----------------------------------------------------------

    def fsf(self, problem, parts, adjoint: bool = False
            ) -> List[torch.Tensor]:
        """The per-λ 'same' FSF convolution (``adjoint``: the flipped FSF)
        of a sharded ``[L, Y, X]`` vector, slab by slab."""
        return _each(lambda slab: _dr._fsf(problem, slab, adjoint, self.h),
                     self.slabs(parts))

    def K(self, problem, c) -> List[torch.Tensor]:
        """K c of a sharded vector (``ops/direct.py::apply_K``)."""
        return self.fsf(problem, _each(
            lambda x: _dr.lsf_apply(x, self.lsf_mat[x.device],
                                    self.lsf[x.device]), c))

    def KT(self, problem, r) -> List[torch.Tensor]:
        """Kᵀ r of a sharded vector (``ops/direct.py::apply_KT``)."""
        return _each(lambda s: _dr.lsf_adjoint(s, self.lsf_mat[s.device],
                                               self.lsf[s.device]),
                     self.fsf(problem, r, adjoint=True))

    def normal_operator(self, problem, tau: float):
        """A(c) = P (Kᵀ W K + τ I) P c on sharded vectors."""
        def A(c):
            out = self.KT(problem, _each(torch.mul, self.K(
                problem, _each(torch.mul, c, self.free)), self.w))
            if tau > 0:
                out = _each(lambda o, x: o + tau * x, out, c)
            return _each(torch.mul, out, self.free)
        return A

    def mean_rhs(self, problem) -> List[torch.Tensor]:
        """Kᵀ W d on the free voxels, sharded: the MAP's right-hand side."""
        return _each(torch.mul, self.KT(problem, _each(
            torch.mul, self.d, self.w)), self.free)


def shards(problem, mesh: Mesh, axis_name: Optional[str] = None) -> Shards:
    """The :class:`Shards` of ``problem`` on ``mesh``'s ``axis_name``, built
    once per problem and (mesh, axis)."""
    axis_name, devices = _axis(mesh, axis_name)
    return sm.cached(problem, ("direct_shards", mesh, axis_name),
                     lambda: Shards(problem, devices))


def make_normal_operator(problem, mesh: Mesh, axis_name=None,
                         prior_precision=None):
    """``ops.direct.make_normal_operator`` on sharded vectors (the row
    blocks of :meth:`Shards.cut`)."""
    return shards(problem, mesh, axis_name).normal_operator(
        problem, _dr._tau(problem, prior_precision))


@dataclasses.dataclass(frozen=True)
class SlotPrecond:
    """M⁻¹'s constants on the slots: per slot the Jacobi diagonal's rows,
    or the (replicated) factors, the factor index of the slot's kx
    columns in their real-view order, and the rows of ``s_map``."""

    mode: str
    diag: Optional[list] = None
    R: Optional[list] = None
    fidx: Optional[list] = None
    s_map: Optional[list] = None


def _slot_precond(problem, sh: Shards, mode: str, tau_m: float
                  ) -> SlotPrecond:
    """The whole problem's preconditioner state (``ops/direct.py``, cached
    there: one Cholesky launch), cut for the slots."""
    p = problem
    st = _dr.precond_state(p, mode, tau_m)
    if mode == "jacobi":
        return SlotPrecond(mode, diag=sh.cut(st.diag))
    Xr = p.X // 2 + 1
    fidx = st.fidx.view(p.Y, Xr, 2)
    return SlotPrecond(
        mode, R=[st.R.to(dev) if m else None
                 for dev, m in zip(sh.devices, sh.mine)],
        fidx=[fidx[:, a:b].reshape(-1).to(dev) if m else None
              for (a, b), dev, m in zip(sh.cols, sh.devices, sh.mine)],
        s_map=None if st.s_map is None else sh.cut(st.s_map))


def _precond_apply(sh: Shards, st: SlotPrecond, r) -> List[torch.Tensor]:
    """M⁻¹ r on sharded vectors: rfft over X, all-to-all to kx columns,
    FFT over Y, one solve launch per slot, and back."""
    if st.mode == "jacobi":
        return _each(lambda x, g, m: x * g * m, r, st.diag, sh.free)
    if st.s_map is not None:
        r = _each(torch.mul, st.s_map, r)
    L = sh.L
    rows = _each(lambda x: torch.fft.rfft(x, dim=-1), r)      # [L, Y_d, Xr]
    row_sizes = [b - a for a, b in sh.rows]
    col_sizes = [b - a for a, b in sh.cols]
    cols = all_to_all_ragged(rows, 2, 1, col_sizes, sh.ranks, row_sizes)
    del rows

    def solve(c, R, fidx):                                    # [L, Y, Xr_e]
        if c.shape[2]:
            # the FFT over a middle axis may hand back permuted strides:
            # the solve runs in place on the λ-major real view
            c = torch.fft.fft(c, dim=1).contiguous()
            v = torch.view_as_real(c).view(L, -1)
            banded.banded_solve(R, fidx, v, out=v)
            c = torch.fft.ifft(c, dim=1)
        return c

    spec = _each(solve, cols, st.R, st.fidx)
    del cols
    rows = all_to_all_ragged(spec, 1, 2, row_sizes, sh.ranks, col_sizes)
    del spec
    out = _each(lambda x: torch.fft.irfft(x, n=sh.X, dim=-1).to(sh.dtype),
                rows)
    if st.s_map is not None:
        out = _each(torch.mul, st.s_map, out)
    return _each(torch.mul, out, sh.free)


def slot_precond(problem, mesh: Mesh, axis_name=None,
                 mode: Optional[str] = None,
                 prior_precision=None) -> SlotPrecond:
    """The slots' preconditioner constants (:class:`SlotPrecond`) for
    ``mode`` (resolved as ``ops.direct`` does) and the M-side ridge of
    ``prior_precision``, built once per problem, (mesh, axis), mode and
    τ_m."""
    p = problem
    axis_name, _ = _axis(mesh, axis_name)
    sh = shards(p, mesh, axis_name)
    mode = _dr._resolve_precond_mode(p, mode)
    tau_m = _dr._precond_tau(p, _dr._tau(p, prior_precision))
    return sm.cached(p, ("direct_shards_precond", mesh, axis_name, mode,
                         tau_m), lambda: _slot_precond(p, sh, mode, tau_m))


def make_preconditioner(problem, mesh: Mesh, axis_name=None,
                        mode: Optional[str] = None, prior_precision=None):
    """``ops.direct.make_preconditioner`` on sharded vectors
    (:func:`slot_precond`'s constants)."""
    sh = shards(problem, mesh, axis_name)
    st = slot_precond(problem, mesh, axis_name, mode, prior_precision)
    return lambda r: _precond_apply(sh, st, r)


# ---------------------------------------------------------------------------
# The two entry points
# ---------------------------------------------------------------------------

def _sharded_draw(problem, mesh: Mesh, axis_name: str):
    """``run_draws``' draw on the slots: the right-hand side's rows on each
    slot (its rows of the Philox normals, or of the injected ones), the
    sharded PCG, x and K x gathered to the problem's device, χ² from the
    slots' float32 partials in slot order."""
    p = problem
    cfg = p.config
    sh = shards(p, mesh, axis_name)
    A = sh.normal_operator(p, _dr._tau(p))
    Minv = make_preconditioner(p, mesh, axis_name)
    tau = _dr._tau(p)

    def normals(key, sweep, streams, given, d):
        y0, y1 = sh.rows[d]
        dev = sh.devices[d]
        if given is not None:
            return given[:, y0:y1].to(dev, sh.dtype)
        return philox.cube_normals(key, sweep, streams, sh.L, sh.Y, sh.X,
                                   dev, sh.dtype, rows=(y0, y1))

    def draw(key, sweep, z, z2):
        streams = (philox.STREAM_DRAW_U1, philox.STREAM_DRAW_U2)
        b = [dd * w + torch.sqrt(w) * normals(key, sweep, streams, z, d)
             if dd is not None else None
             for d, (dd, w) in enumerate(zip(sh.d, sh.w))]
        b = _each(torch.mul, sh.KT(p, b), sh.free)
        if tau > 0:
            streams = (philox.STREAM_PRIOR_U1, philox.STREAM_PRIOR_U2)
            b = [x + float(np.sqrt(tau)) * normals(key, sweep, streams, z2,
                                                   d) * m
                 if x is not None else None
                 for d, (x, m) in enumerate(zip(b, sh.free))]
        res = _dr.pcg(A, Minv, b, cfg.direct_tol, cfg.direct_maxiter,
                      sh.ops)
        del b
        kx = sh.K(p, res.x)

        def chi2_part(dd, k, w):
            r = torch.where(w > 0, dd - k, torch.zeros_like(k))
            return torch.sum(r * r * w, dtype=torch.float32)

        chi2 = slot_sum(_each(chi2_part, sh.d, kx, sh.w), sh.ranks)
        return (_dr.PCGResult(x=sh.gather(res.x, p.device),
                              iterations=res.iterations,
                              rel_residual=res.rel_residual),
                sh.gather(kx, p.device), chi2.to(p.device))

    return draw


def run_direct_sweeps_sharded(problem, state, n_sweeps: int, mesh: Mesh,
                              axis_name: Optional[str] = None,
                              normals=None) -> sm.ChainResult:
    """``ops.direct.direct_run_sweeps`` over the slots of ``mesh``'s
    ``axis_name`` (the ChainResult contract, state in and out whole on the
    problem's device).  Draw for draw the same chain as the unsharded
    path, the same Philox normals (``normals`` = (z, z2) as there, cut by
    rows); floats match to the solver's tolerance."""
    p = problem
    if p.config.sampler != "direct":
        raise ValueError(
            f"run_direct_sweeps_sharded needs sampler='direct', got "
            f"{p.config.sampler!r}")
    axis_name, _ = _axis(mesh, axis_name)
    with cv.no_tf32():
        return _dr.run_draws(p, state, n_sweeps, normals,
                             _sharded_draw(p, mesh, axis_name))


def posterior_mean_sharded(problem, mesh: Mesh,
                           axis_name: Optional[str] = None, tol=None,
                           maxiter=None, prior_precision=None
                           ) -> _dr.PCGResult:
    """``ops.direct.posterior_mean`` over the slots of ``mesh``'s
    ``axis_name`` (PCGResult, x whole on the problem's device), with its
    float64 refinement of a float32 solve on float64 copies of the slot
    constants.  ``Run.map_estimate`` routes here when ``spatial_mesh`` is
    set."""
    p = problem
    axis_name, devices = _axis(mesh, axis_name)
    cfg = p.config
    tol = cfg.direct_tol if tol is None else tol
    maxiter = cfg.direct_maxiter if maxiter is None else maxiter
    tau = _dr._tau(p, prior_precision)

    def make64():
        p64 = _dr._float64(p)
        sh64 = Shards(p64, devices)
        return sh64.normal_operator(p64, tau), sh64.mean_rhs(p64)

    with cv.no_tf32():
        sh = shards(p, mesh, axis_name)
        A = sh.normal_operator(p, tau)
        M = make_preconditioner(p, mesh, axis_name,
                                prior_precision=prior_precision)
        res = _dr.pcg(A, M, sh.mean_rhs(p), tol, maxiter, sh.ops)
        if p.data_pad.dtype != torch.float64:
            res = _dr.refine(A, M, res, make64, tol, maxiter, sh.ops)
    return _dr.PCGResult(x=sh.gather(res.x, p.device),
                         iterations=res.iterations,
                         rel_residual=res.rel_residual)
