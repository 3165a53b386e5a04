"""Spatially-sharded sampling: ONE chain's sweep spans the slots of a mesh.

Counterpart of ``deconv3d_tpu/parallel/sweep_sharded.py``.  The spaxel
grid is cut along Y into D shards, one per slot of the mesh axis, and the
color-decomposed sweep runs on every shard.  The state enters and leaves
every segment whole, on the problem's device, which so holds the whole
field besides its own shard: D devices share the sweep's work but do not
lower that device's peak memory (shard states kept across segments are
still to come).  The slots may belong to several ranks
(``parallel/multihost.py``'s global mesh): each rank then sweeps its own
shards, the strip pushes cross the ranks, and every rank ends the segment
with the whole state (gathered by :func:`sharded_segment`).

  * Shard d owns the spaxel block rows [d·nyl, (d+1)·nyl) and holds the
    padded residual rows [d·nyl·f, d·nyl·f + nyl·f + f − 1): the last f − 1
    rows REPLICATE the next shard's first f − 1 rows (they always hold the
    same values, as the zero pads of the single-device layout do).  A shard
    is itself a problem of nyl block rows (:func:`cut_problem`,
    :func:`cut_state`), so the single-device sweep code runs on it as it
    is.
  * Same-color spaxels are exactly f apart, across shard edges too, so
    their patches stay disjoint and the color decomposition holds.
  * After every color each shard's committed patch delta on its first and
    last f − 1 rows goes to its neighbours (``parallel/mesh.py``
    ``ppermute``, across ranks where the neighbour is another rank's) and
    is subtracted there: the replicas get the very operation their owners
    got, so they stay bit-equal.

Random numbers: every shard reads its rows of the whole field's uniforms
(Philox keyed by the field's spaxel row, ``ops/philox.py``), so a D-shard
run is the single-device plain sweep bit for bit (residual, clean,
log-scales, decisions, χ²; the flux trace sums the shards' partial sums).

The per-color step is the plain one of ``ops/sweep.py`` for every sampler,
as the JAX package runs its jnp step here, by design; ``gibbs_block``'s
per-color draw still launches the banded kernel on a CUDA device.
:func:`sharded_segment` runs the sweeps in the one-device segment's body
(``ops/sweep.py`` ``_segment``); the kernel-rate path for ``'mh'`` and
``'gibbs'`` is ``parallel/kernel_sharded.py``, on the same segment.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import sampler as sm
from ..ops import banded
from ..ops import sweep as sw
from . import mesh as pm
from .mesh import Mesh, ppermute


# ---------------------------------------------------------------------------
# Overlap (halo-replicated) layout
# ---------------------------------------------------------------------------

def _overlap_rows(Hp: int, f: int, ndev: int):
    BY = Hp - (f - 1)
    if BY % ndev:
        raise ValueError(f"Yc={BY} must be divisible by the mesh size {ndev}")
    BYl = BY // ndev
    return BYl, BYl + f - 1


def overlap_blocks(resid: torch.Tensor, f: int,
                   ndev: int) -> List[torch.Tensor]:
    """``[..., Hp, Wp]`` → the ``ndev`` blocks ``[..., Hpl, Wp]`` (views):
    block d holds padded rows [d·BYl, d·BYl + Hpl), Hpl = BYl + f − 1."""
    BYl, Hpl = _overlap_rows(resid.shape[-2], f, ndev)
    return [resid.narrow(-2, d * BYl, Hpl) for d in range(ndev)]


def overlap_shard(resid: torch.Tensor, f: int, ndev: int) -> torch.Tensor:
    """``[L, Hp, Wp]`` → ``[L, ndev·Hpl, Wp]``, the blocks of
    :func:`overlap_blocks` side by side (the JAX package's layout)."""
    return torch.cat(overlap_blocks(resid, f, ndev), dim=-2)


def overlap_unshard(resid_sh: torch.Tensor, f: int, ndev: int) -> torch.Tensor:
    """Inverse of :func:`overlap_shard`: drop the replicated rows, keeping
    every block's owned rows, then the global tail pad rows, which only
    the last block holds."""
    blocks = torch.chunk(resid_sh, ndev, dim=-2)
    BYl = blocks[0].shape[-2] - (f - 1)
    return torch.cat([b.narrow(-2, 0, BYl) for b in blocks]
                     + [blocks[-1].narrow(-2, BYl, f - 1)], dim=-2)


def cut_problem(p: sm.Problem, by0: int, nyb: int, device=None) -> sm.Problem:
    """The problem of block rows [by0, by0 + nyb): its padded residual rows
    [by0·f, by0·f + nyb·f + f − 1) of the weights, its spaxel rows of every
    per-spaxel constant, on ``device`` (views where it is ``p``'s).  Its
    sweeps never read the data, which it does not carry."""
    f = p.f
    dev = p.device if device is None else torch.device(device)
    y0, cells = by0 * f, nyb * f

    def rows(t, n):
        return None if t is None else t.narrow(-2, y0, n).to(dev)

    def whole(t):
        return None if t is None else t.to(dev)

    return dataclasses.replace(
        p, Y=max(0, min(p.Y - y0, cells)), ny=nyb,
        fsf=whole(p.fsf), lsf=whole(p.lsf),
        data_pad=torch.empty((0,), dtype=p.w_pad.dtype, device=dev),
        w_pad=rows(p.w_pad, cells + f - 1), quad=rows(p.quad, cells),
        valid=rows(p.valid, cells), monitor_idx=whole(p.monitor_idx),
        fsf_spec=whole(p.fsf_spec), fsf_imgs=whole(p.fsf_imgs),
        qvox=rows(p.qvox, cells), quad_lo=rows(p.quad_lo, cells),
        chol=None if p.chol is None else p.chol[y0:y0 + cells].to(dev),
        quad_mean=None)


def cut_state(s: sm.SamplerState, f: int, by0: int, nyb: int,
              device) -> sm.SamplerState:
    """The (chain-stacked or single) state of block rows [by0, by0 + nyb),
    as :func:`cut_problem` cuts the problem, on ``device``."""
    y0, cells = by0 * f, nyb * f
    out = {}
    for fld in dataclasses.fields(s):
        t = getattr(s, fld.name)
        if fld.name == "resid":
            t = t.narrow(-2, y0, cells + f - 1)
        elif fld.name in ("clean", "log_scale", "sum_clean") or (
                fld.name == "sum_sq" and t.shape[-2] == s.clean.shape[-2]):
            t = t.narrow(-2, y0, cells)
        out[fld.name] = t.to(device)
    return sm.SamplerState(**out)


def shard_problems(p: sm.Problem, devices: pm.Slots):
    """The D shard problems of ``p`` on the slots ``devices``
    (:func:`cut_problem`; None for the slots of other ranks), built once
    per problem and slots (``sampler.cached``)."""
    nyl = p.ny // len(devices)
    return sm.cached(p, ("shards", tuple(map(str, devices)), devices.ranks),
                     lambda: [cut_problem(p, d * nyl, nyl, dev) if m else None
                              for d, (dev, m) in enumerate(
                                  zip(devices, devices.local()))])


def mesh_axis(mesh: Mesh, axis_name: str) -> List[torch.device]:
    """The slots of a 1-D mesh's ``axis_name``."""
    rows = mesh.rows(axis_name)
    if len(rows) != 1:
        raise ValueError(
            f"one chain's sweep shards over a 1-D mesh; this mesh has axes "
            f"{mesh.axis_names} (for chains x spatial see "
            "kernel_sharded.run_chains_kernel_sharded)")
    return rows[0]


# ---------------------------------------------------------------------------
# The sharded segment
# ---------------------------------------------------------------------------

def sharded_segment(problem: sm.Problem, state: sm.SamplerState,
                    n_sweeps: int, uniforms: Optional[torch.Tensor],
                    mode: str, devices, make_sweep, kernel: bool = False,
                    tile=None) -> sw.Segment:
    """A segment of ``mode`` on the shards of ``devices``, in the body of
    the one-device segment (``ops/sweep.py`` ``_segment``: its head,
    per-sweep work, tail and spans).  Shard d is the state's block rows
    [d·nyl, (d+1)·nyl) (:func:`cut_state`, :func:`shard_problems`) in its
    segment layout on ``devices[d]`` (the kernel's with ``kernel``, its
    tiled scan in ``tile``); every sweep is ``make_sweep(shards, ranks)
    (sweep, adapt, uniforms, out_a, out_b)`` on lists over the shards (each
    shard's rows of the field's uniforms, None where the kernels draw their
    own; None for the shards of other ranks of a ``mesh.Slots``).  The
    outputs are gathered in the field's row order, the flux summed in slot
    order and the new state joined on the problem's device: on every rank,
    bit-equal to the one-device segment."""
    p, dev = problem, problem.device

    def lay(states):
        slots = devices if isinstance(devices, pm.Slots) else pm.Slots(
            devices)
        D = len(slots)
        if p.ny % D:
            raise ValueError(f"ny={p.ny} color-rows must be divisible by the "
                             f"mesh size {D}")
        f, nyl = p.f, p.ny // D
        BYl, nijl = nyl * f, nyl * p.nx
        # each shard's monitored voxels: (their slots, indices in its clean)
        mon_at = [sw._monitored(p, d * BYl, BYl) for d in range(D)]
        # this process's shards; None for the slots of other ranks
        runs = []
        for d, sp in enumerate(shard_problems(p, slots)):
            st = None if sp is None else cut_state(states, f, d * nyl, nyl,
                                                   slots[d])
            runs.append(None if st is None else sw._Running.of(
                sw.sweep_state(sp, st, mode, kernel, tile), st, p,
                mon_at[d][1].to(slots[d]), n_sweeps))
        shard_sweep = make_sweep([None if r is None else r.k for r in runs],
                                 slots.ranks)

        def each(fn):
            return [None if r is None else fn(d, r)
                    for d, r in enumerate(runs)]

        def sweep(s, sweep_abs, adapt, u, u_out):
            # a shard's rows of the field's uniforms
            shard_sweep(sweep_abs, adapt, each(
                lambda d, r: None if u is None else
                u[:, :, d * nijl:(d + 1) * nijl].to(slots[d]).contiguous()),
                each(lambda d, r: r.accept[s]), each(lambda d, r: r.dchi[s]))

        def joined(fn, dim):
            """``fn(d, shard)`` of this process's shards concatenated along
            ``dim`` on ``dev``, on every rank."""
            return pm.gather(each(fn), dev, dim, slots.ranks)

        def outputs():
            return (joined(lambda d, r: r.accept, 3),
                    joined(lambda d, r: r.dchi, 3),
                    # the flux: the shards' partial sums added in slot order
                    pm.slot_sum(each(lambda d, r: torch.stack(r.flux).to(dev)),
                                slots.ranks),
                    joined(lambda d, r: torch.stack(r.mon).to(dev), 2),
                    torch.cat([at for at, _ in mon_at]))

        def rows(fn):
            """``fn(shard)`` in the λ-first layout, joined along the rows."""
            return joined(lambda d, r: sw._lambda_first(fn(r)), -2)

        def fields():
            return dict(
                # every shard's owned rows, then the field's tail pad rows,
                # which only the last shard holds
                resid=joined(lambda d, r: sw._lambda_first(
                    r.k.resid[..., :p.L]).narrow(
                        -2, 0, BYl + (f - 1 if d == D - 1 else 0)), -2),
                clean=rows(lambda r: r.k.clean),
                log_scale=joined(lambda d, r: r.k.log_scale, -2),
                sum_clean=rows(lambda r: r.sum_clean),
                sum_sq=(rows(lambda r: r.sum_sq)
                        if p.config.track_variance else None))
        return [r for r in runs if r is not None], sweep, outputs, fields
    return sw._segment(p, state, n_sweeps, uniforms, False, mode, kernel, lay)


# ---------------------------------------------------------------------------
# The plain per-color sweep with the halo exchange
# ---------------------------------------------------------------------------

def edge_deltas(delta: torch.Tensor, c: int, f: int, Wp: int):
    """The committed delta ``[C, nyl, f, nx, f, L]`` of a whole-shard step
    of color ``c`` on the shard's first f − 1 rows (head) and on its last
    f − 1 rows (tail, the next shard's head replicas): two
    ``[C, f − 1, Wp, L]`` strips, zero where the color touched nothing.
    Only the first and last block rows are read: ``delta`` may hold just
    those two."""
    C, nyl, _, nx, _, L = delta.shape
    cy, cx = divmod(c, f)
    head = delta.new_zeros((C, f - 1, Wp, L))
    tail = delta.new_zeros((C, f - 1, Wp, L))
    # block row 0's patch rows a < f − 1 − cy lie on head rows cy + a;
    # block row nyl − 1's rows a ≥ f − cy on tail rows cy + a − f
    if cy < f - 1:
        head[:, cy:, cx:cx + nx * f] = delta[:, 0, : f - 1 - cy].reshape(
            C, f - 1 - cy, nx * f, L)
    if cy > 0:
        tail[:, :cy, cx:cx + nx * f] = delta[:, nyl - 1, f - cy:].reshape(
            C, cy, nx * f, L)
    return head, tail


def _color_sweep(mode: str):
    """``make_sweep`` of :func:`sharded_segment` for the plain color step:
    per color every shard's step, then its head and tail deltas pushed to
    the neighbours' replicas (``ranks``: the slots' owners; this process
    steps its own shards)."""
    def make(ks, ranks):
        mine = [d for d, k in enumerate(ks) if k is not None]
        f = ks[mine[0]].f
        halo, BYl = f - 1, ks[mine[0]].ny * f
        Wp = ks[mine[0]].resid.shape[2]

        def sweep(sweep_abs, adapt, us, outs_a, outs_b):
            for c in range(f * f):
                heads, tails = [None] * len(ks), [None] * len(ks)
                for d in mine:
                    k, u, a, b = ks[d], us[d], outs_a[d], outs_b[d]
                    if mode == "mh":
                        g = sw._mh_step_torch(k, c, 0, 0, adapt, u, a, b)
                    elif mode == "gibbs":
                        g = sw._gibbs_step_torch(k, c, 0, 0, u, a, b)
                    else:
                        g = sw._block_step(k, c, u, a, b,
                                           banded.sample_conditional)
                    if halo and len(ks) > 1:
                        # the delta of the first and last block rows only
                        # (the step committed it λ-chunk by λ-chunk)
                        heads[d], tails[d] = edge_deltas(
                            sw.patch_delta(k, g[:, [0, -1]]), c, f, Wp)
                if not halo or len(ks) == 1:
                    continue
                # the next shard's head delta lands on my tail replicas, the
                # previous shard's tail delta on my head rows
                for k, nxt, prv in zip(ks, ppermute(heads, -1, ranks),
                                       ppermute(tails, 1, ranks)):
                    if k is not None:
                        k.resid[:, BYl:] -= nxt
                        k.resid[:, :halo] -= prv
        return sweep
    return make


def run_sweeps_sharded(problem: sm.Problem, state: sm.SamplerState,
                       n_sweeps: int, mesh: Mesh, axis_name: str = "sp",
                       uniforms: Optional[torch.Tensor] = None
                       ) -> sm.ChainResult:
    """Run ``n_sweeps`` full sweeps of ONE chain sharded over ``mesh``.

    State in and out in the standard single-device layout (a chain-stacked
    state shards every chain alike, batched on each shard).  All three
    sampler modes shard: ``'mh'`` (with or without positivity), ``'gibbs'``
    (truncated-normal positivity draws included) and ``'gibbs_block'`` (its
    Cholesky factors shard with the rows).  With ``coarse_every`` set, the
    coarse passes interleave at absolute-sweep boundaries, and the χ²
    rebaseline as ``sampler.run_sweeps`` places it: the run is the
    single-device plain one bit for bit.  ``uniforms`` (a segment without
    passes) as in ``ops/sweep.py``."""
    cfg = problem.config
    if cfg.sampler == "direct":
        raise ValueError(
            "sampler='direct' draws are already whole-cube solves — "
            "spatial sharding of the sweep does not apply (it would "
            "silently run MH); drop spatial_mesh for direct runs.")
    if problem.quad is None:
        raise ValueError("the sharded sweep needs the problem's quad "
                         "(make_problem with an MCMC sampler)")
    devices = mesh_axis(mesh, axis_name)
    mode = cfg.sampler

    def inner(s, k):
        return sharded_segment(problem, s, k, uniforms, mode, devices,
                               _color_sweep(mode)).result

    return sm.interleaved(problem, state, n_sweeps, inner)
