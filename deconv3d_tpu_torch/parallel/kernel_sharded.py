"""Kernel-rate spatially-sharded sampling: the band launches of K2.

Counterpart of ``deconv3d_tpu/parallel/kernel_sharded.py``.
``parallel/sweep_sharded.py`` shards one chain's sweep with the plain
color step; this module keeps every phase of an ``'mh'`` or ``'gibbs'``
sweep on the tiled kernel (``csrc/tiled_sweep.cu``), with two strip
exchanges per sweep:

  * The spaxel grid is Y-sharded with the halo-replicated residual of
    ``sweep_sharded`` (each shard its padded rows plus f − 1 replicated
    neighbour rows), in the port's own ``[C, Hpl, Wp, Ls]`` segment layout
    per shard (``sweep_sharded.sharded_segment``).
  * Each shard's block rows split into three bands — TOP (block row 0),
    INTERIOR (1 .. nyl − 2), BOTTOM (nyl − 1) — and each band is one launch
    of the tiled kernel over its own sub-grid inside the shard's buffer:
    the kernel's band arguments (the TPU kernel's ``y_base``) start its
    window at the band's row and key its random numbers by the field's
    rows (``ops/tiled.py`` ``band_sweep``).  No data moves between bands.
  * Interaction: interior patches never touch the rows a shard shares; two
    shards' TOP bands interact only through a BOTTOM band, and the other
    way round.  So the fixed scan order [interior | all tops | strip push |
    all bottoms | strip push] needs the replicas synchronised twice: after
    the tops (each head strip's change onto the previous shard's tail
    replicas) and after the bottoms (each tail strip's change onto the next
    shard's head), then the tail replicas refreshed from their owners'
    final rows, so that they stay bit-equal to them.

Several processes: on a mesh whose slots belong to several ranks
(``parallel/multihost.py``'s global mesh) each rank launches the bands of
its own shards, the strip pushes and the tail refresh go through the
rank-aware ``ppermute``, and every rank ends each segment with the whole
state, bit-equal to the one-process mesh of the same slots; the
whole-field steps between segments (χ² rebaseline, coarse pass) run on
every rank on that same state.  On a (chains, spatial) mesh a rank runs
the chain rows it holds slots of, and the rows' results are gathered
along the chain axis.

The band decomposition is a fixed scan order of the same single-site
updates, so the chain targets the posterior of every other engine.  The
Philox draws are keyed by the field's spaxel row and the absolute sweep:
any segmentation, and a resume, is bit-exact, and a chain draws the same
numbers under any D; the scan order, and so the chain, depends on D.

``interior``: ``'cuda'`` (the band launches; the default on a CUDA
problem; a failed build or launch raises) or ``'torch'`` (the same band
scans in plain torch: the kernel's plain version, and the CPU path).

Not ported: the Mosaic window layout (``_to_window*``, ``_from_window*``,
``_pad_lanes``, the 16-aligned ``global_window_width``), ``_strided_cols``,
the jit caches and the donation paths for the v5e's 15 GiB.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import chains as ch
from .. import sampler as sm
from ..ops import sweep as sw
from ..ops import tiled
from .mesh import Mesh, ppermute
from .sweep_sharded import mesh_axis, sharded_segment


def _band_rows(nyl: int, f: int):
    """(rows0, n_blockrows, y_base) for the top/interior/bottom bands."""
    bands = [("top", 0, 1, 0)]
    if nyl > 2:
        bands.append(("interior", f, nyl - 2, f))
    bands.append(("bottom", (nyl - 1) * f, 1, (nyl - 1) * f))
    return bands


def _band_plan(p: sm.Problem, ndev: int):
    """Per band (name, rows0, nyb, y_base, tile): the band's tile planned
    as the tiled engine plans a field's (``ops/tiled.py`` ``plan_tiles``
    under ``WINDOW_BUDGET_BYTES``)."""
    f, nx, L = p.f, p.nx, p.L
    plan = []
    for name, rows0, nyb, y_base in _band_rows(p.ny // ndev, f):
        tile_b = tiled.plan_tiles(f, nyb, nx, L, tiled.WINDOW_BUDGET_BYTES)
        if tile_b is None:
            raise ValueError("no per-band tiling fits the window budget")
        plan.append((name, rows0, nyb, y_base, tile_b))
    return plan


def _check_kernel_shardable(p: sm.Problem, mesh: Mesh, axis_name: str,
                            interior: Optional[str]) -> str:
    """Shared validation for the kernel-rate sharded entry points; returns
    the resolved ``interior``."""
    cfg = p.config
    if cfg.sampler not in ("mh", "gibbs"):
        raise ValueError(
            "kernel-rate sharding supports sampler='mh' and 'gibbs' "
            "(the band kernels carry both modes); use "
            "parallel.sweep_sharded for other modes.")
    if cfg.positivity:
        raise ValueError("positivity is not supported on this path")
    if p.fsf_spec is None:
        raise ValueError(
            "problem lacks low-rank FSF factors — build it with an MCMC "
            "sampler")
    if interior is None:
        interior = "cuda" if p.device.type == "cuda" else "torch"
    if interior not in ("cuda", "torch"):
        raise ValueError(f"interior must be 'cuda' or 'torch', got "
                         f"{interior!r}")
    if axis_name not in mesh.shape:
        raise ValueError(
            f"mesh has no {axis_name!r} axis (axes: {mesh.axis_names})")
    ndev = mesh.shape[axis_name]
    if interior == "cuda" and any(d.type != "cuda" for d in
                                  mesh.devices.reshape(-1)):
        raise ValueError("interior='cuda' launches the band kernels: every "
                         f"slot of the mesh must be a CUDA device ({mesh})")
    if p.ny % ndev:
        raise ValueError(
            f"ny={p.ny} color-rows must be divisible by the mesh size "
            f"{ndev}")
    if p.ny // ndev < 2:
        raise ValueError(
            f"need ≥2 block-rows per shard (ny={p.ny}, D={ndev})")
    return interior


def _band_sweep(plan, mode: str, kernel: bool):
    """``make_sweep`` of ``sweep_sharded.sharded_segment``: per shard
    one carried state and a view of it per band (the band's tile, waves
    and rows; the shard's field row ``gy0``), run in the module's scan
    order on this process's shards (``ranks``: the slots' owners)."""
    def make(ks: List[sw._SweepState], ranks):
        mine = [d for d, k in enumerate(ks) if k is not None]
        f = ks[mine[0]].f
        halo, BYl = f - 1, ks[mine[0]].ny * f
        nyl, D = ks[mine[0]].ny, len(ks)
        bands = {d: [dataclasses.replace(
            ks[d], tile=tile_b, rows=(rows0 // f, nyb), gy0=d * nyl,
            waves=tiled.wave_schedule(nyb // tile_b[0],
                                      ks[d].nx // tile_b[1]),
            wave_tables=None, scratch=None)
            for (_, rows0, nyb, _, tile_b) in plan] for d in mine}

        def each(fn, *lists):
            return [fn(*args) if args[0] is not None else None
                    for args in zip(*lists)]

        def sweep(sweep_abs, adapt, us, outs_a, outs_b):
            def run(bi):
                for d in mine:
                    tiled.band_sweep(bands[d][bi], mode, sweep_abs, adapt,
                                     us[d], outs_a[d], outs_b[d], kernel)

            if len(plan) == 3:
                run(1)                 # interior first: no shared rows
            old_top = each(lambda k: k.resid[:, :halo].clone(), ks)
            run(0)                     # tops
            if D > 1 and halo:
                # my head strip's change belongs on the previous shard's
                # tail replicas
                d_top = each(lambda o, k: o - k.resid[:, :halo], old_top, ks)
                for k, dn in zip(ks, ppermute(d_top, -1, ranks)):
                    if k is not None:
                        k.resid[:, BYl:] -= dn
            old_bot = each(lambda k: k.resid[:, BYl:].clone(), ks)
            run(len(plan) - 1)         # bottoms: see the tops' pushes
            if D > 1 and halo:
                d_bot = each(lambda o, k: o - k.resid[:, BYl:], old_bot, ks)
                for k, dp in zip(ks, ppermute(d_bot, 1, ranks)):
                    if k is not None:
                        k.resid[:, :halo] -= dp
                # the lumped strip changes land within an ulp of the
                # owners' own per-color updates: refresh the tail replicas
                # from the owners' final head rows (the last shard's tail
                # rows are the field's pad rows and keep their values)
                heads = ppermute(each(lambda k: k.resid[:, :halo], ks), -1,
                                 ranks)
                for k, h in zip(ks[:-1], heads[:-1]):
                    if k is not None:
                        k.resid[:, BYl:] = h
        return sweep
    return make


def segment(problem: sm.Problem, state: sm.SamplerState, n_sweeps: int,
            devices, interior: str,
            uniforms: Optional[torch.Tensor] = None) -> sw.Segment:
    """One segment of the band sweeps on the spatial slots ``devices``
    (no rebaseline, no coarse pass), with its per-(color, spaxel) outputs:
    what :func:`run_sweeps_kernel_sharded` runs between its boundaries."""
    mode = problem.config.sampler
    plan = _band_plan(problem, len(devices))
    kernel = interior == "cuda"
    return sharded_segment(problem, state, n_sweeps, uniforms, mode, devices,
                           _band_sweep(plan, mode, kernel),
                           kernel=kernel, tile=plan[0][4])


def run_sweeps_kernel_sharded(
    problem: sm.Problem,
    state: sm.SamplerState,
    n_sweeps: int,
    mesh: Mesh,
    axis_name: str = "sp",
    interior: Optional[str] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> sm.ChainResult:
    """Run ``n_sweeps`` of ONE chain Y-sharded over ``mesh`` at kernel rate.

    ``problem``: ``sampler='mh'`` or ``'gibbs'`` without positivity.
    ``interior``: ``'cuda'`` (default on a CUDA problem: the band launches)
    or ``'torch'`` (the plain band scans; the CPU path).  State in and out
    in the standard single-device layout (a chain-stacked state shards
    every chain alike, batched in each launch).  With ``chi2_rebaseline_every``
    and ``coarse_every`` set, the rebaselines and the coarse passes
    interleave at absolute-sweep boundaries as on the single-device
    engines.  ``uniforms`` (a segment without passes) replaces the Philox
    draws, as in ``ops/sweep.py``."""
    interior = _check_kernel_shardable(problem, mesh, axis_name, interior)
    devices = mesh_axis(mesh, axis_name)
    return sm.interleaved(problem, state, n_sweeps, lambda s, k: segment(
        problem, s, k, devices, interior, uniforms).result)


def run_chains_kernel_sharded(
    problem: sm.Problem,
    n_chains: int,
    n_sweeps: int,
    mesh: Mesh,
    states: Optional[sm.SamplerState] = None,
    chain_axis: str = "ch",
    axis_name: str = "sp",
    interior: Optional[str] = None,
) -> ch.MultiChainResult:
    """Chain parallelism × kernel-rate spatial sharding on a 2-D mesh.

    Mesh axes ``(chain_axis, axis_name)``: ``n_chains`` independent chains,
    chain i Y-sharded over the slots of mesh row i, with every sweep phase
    on the band kernels.  One chain per mesh row
    (``mesh.shape[chain_axis] == n_chains``); the strip exchanges and sums
    stay inside a row, so each chain is bit-equal to itself run alone on
    its row's spatial mesh.  Returns a ``chains.MultiChainResult``; the
    coarse passes and rebaselines as in
    :func:`run_sweeps_kernel_sharded`, every chain at the same absolute
    sweep."""
    p = problem
    interior = _check_kernel_shardable(p, mesh, axis_name, interior)
    if chain_axis not in mesh.shape:
        raise ValueError(
            f"mesh has no {chain_axis!r} axis (axes: {mesh.axis_names})")
    n_ch = mesh.shape[chain_axis]
    if n_chains != n_ch:
        raise ValueError(
            f"one chain per {chain_axis!r} mesh row: n_chains={n_chains} "
            f"must equal mesh.shape[{chain_axis!r}]={n_ch}")
    if states is None:
        states = ch.init_chain_states(p, n_chains)
    rows = mesh.rows(axis_name)
    columns = mesh.rows(chain_axis)

    def inner(s, k):
        # this process's chain rows; every chain on every rank after
        results = [ch.stack_chains([segment(
            p, ch.select_chains(s, i), k, rows[i], interior).result])
            if any(rows[i].local()) else None for i in range(n_chains)]
        return _join_rows(results, columns, p.device)

    return ch.MultiChainResult(result=sm.interleaved(p, states, n_sweeps,
                                                     inner))


def _join_rows(results, columns, device):
    """The chain rows' results (each whole on its row's ranks, None on the
    others) joined along the chain axis on every rank of the mesh: one
    gather over each column of the chain axis that reaches a rank the
    earlier ones did not."""
    reached, joined = set(), None
    for col in columns:
        if set(col.ranks) <= reached:
            continue
        reached |= set(col.ranks)
        got = ch.gather_chains([r if mine else None for r, mine in
                                zip(results, col.local())], col, device) \
            if any(col.local()) else None
        joined = joined or got
    return joined
