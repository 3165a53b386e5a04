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
with the whole state (gathered by ``ops/sweep.py`` ``_run_segment``).

  * Shard d owns the spaxel block rows [d·nyl, (d+1)·nyl) and holds the
    padded residual rows [d·nyl·f, d·nyl·f + nyl·f + f − 1): the last f − 1
    rows REPLICATE the next shard's first f − 1 rows (they always hold the
    same values, as the zero pads of the single-device layout do).  A shard
    is itself a problem of nyl block rows (``ops/sweep.py`` ``cut_problem``,
    ``cut_state``), so the single-device sweep code runs on it as it is.
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
per-color draw still launches the banded kernel on a CUDA device.  Around
the sweeps runs the single-device segment itself (``ops/sweep.py``
``_run_segment`` with ``devices``: the shards' layout, the outputs in the
field's row order, the Kahan χ², accumulators and traces).  The
kernel-rate path for ``'mh'`` and ``'gibbs'`` is
``parallel/kernel_sharded.py``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import sampler as sm
from ..ops import banded
from ..ops import sweep as sw
from ..ops.sweep import overlap_join
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
    """Inverse of :func:`overlap_shard`: drop the replicated rows."""
    return overlap_join(torch.chunk(resid_sh, ndev, dim=-2), f)


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


def _color_sweep(mode: str, ranks=None):
    """``make_sweep`` of a sharded ``ops.sweep._run_segment`` for the plain
    color step: per color every shard's step, then its head and tail
    deltas pushed to the neighbours' replicas (``ranks``: the slots'
    owners; this process steps its own shards)."""
    def make(ks):
        mine = [d for d, k in enumerate(ks) if k is not None]
        f = ks[mine[0]].f
        halo, BYl = f - 1, ks[mine[0]].ny * f
        Wp = ks[mine[0]].resid.shape[2]

        def sweep(sweep_abs, adapt, us, outs_a, outs_b, u_out):
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
        return sw._run_segment(problem, s, k, uniforms, False, mode,
                               devices=devices,
                               make_sweep=_color_sweep(mode, devices.ranks)
                               ).result

    return sm.interleaved(problem, state, n_sweeps, inner)
