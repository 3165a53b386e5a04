"""The tiled scan's schedules and the kernels' tuning rules (``ops/tiled.py``
``wave_schedule``, ``ops/sweep.py`` ``phase_slab`` / ``slab_phases_reference``).

On the CPU: the wavefront schedule's order properties; the plain tiled scan
run wave by wave (colors interleaved across a wave's tiles) against the
raster scan, bit for bit, mh and gibbs, one chain and a batch of two (the
raster scan itself is held against the JAX package's per-color functions in
``tests/test_torch_tiled.py``); gibbs phase (b) run slab by slab over
windows against the full-spectrum phase loop, bit for bit at the derived
margins and broken one wavelength short; the slab rule; the task clocks'
labels against the kernels' markers.

On the card (``gpu`` marker): the tiled kernel with the wavefront schedule
against the raster schedule, bit for bit, and under every setting of its
knobs; one tile against the whole-cube kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.ops import resident as rs
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.ops import tiled as tl

_FIELDS = ("clean", "resid", "log_scale", "sum_clean", "sum_sq", "chi2",
           "n_accept", "n_propose")


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _windows_meet(a, b, Tx, ny_t, nx_t, f):
    """Whether the windows (owned rows and columns plus f − 1 of halo) of
    raster tiles ``a`` and ``b`` share a pixel."""
    (ai, aj), (bi, bj) = divmod(a, Tx), divmod(b, Tx)
    BY, BX = ny_t * f, nx_t * f
    rows = ai * BY < bi * BY + BY + f - 1 and bi * BY < ai * BY + BY + f - 1
    cols = aj * BX < bj * BX + BX + f - 1 and bj * BX < aj * BX + BX + f - 1
    return rows and cols


@pytest.mark.parametrize("Ty, Tx", [(1, 1), (1, 5), (5, 1), (2, 2), (4, 2),
                                    (3, 7), (18, 9), (18, 18)])
def test_wavefront_keeps_the_raster_order(Ty, Tx):
    waves = tl.wave_schedule(Ty, Tx)
    assert sorted(t for w in waves for t in w) == list(range(Ty * Tx))
    assert len(waves) == (2 * (Ty - 1) + Tx if Tx > 1 else Ty)
    wave_of = {t: k for k, w in enumerate(waves) for t in w}
    for t in range(Ty * Tx):
        ti, tj = divmod(t, Tx)
        assert wave_of[t] == (2 * ti + tj if Tx > 1 else ti)
        # every neighbour that precedes it in raster order is in an earlier
        # wave, every later one in a later wave
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ui, uj = ti + di, tj + dj
                if (di, dj) == (0, 0) or not (0 <= ui < Ty and 0 <= uj < Tx):
                    continue
                u = ui * Tx + uj
                assert (wave_of[u] < wave_of[t]) == (u < t), (t, u)
    # tiles of one wave share no window, whatever the tile and footprint
    for ny_t, nx_t, f in ((1, 1, 3), (1, 2, 17), (2, 1, 5)):
        for w in waves:
            for a in w:
                assert not any(_windows_meet(a, b, Tx, ny_t, nx_t, f)
                               for b in w if b != a)


def test_raster_is_one_tile_per_wave():
    assert tl.wave_schedule(2, 3, "raster") == [[0], [1], [2], [3], [4], [5]]
    assert tl.wave_schedule(2, 3) == [[0], [1], [2, 3], [4], [5]]
    assert tl.wave_schedule(3, 1) == [[0], [1], [2]]
    with pytest.raises(ValueError, match="schedule must be"):
        tl.wave_schedule(2, 2, "diagonal")
    # the full MUSE field, 18 × 18 blocks: the dependent steps of a sweep
    for tile, waves, widest in (((1, 2), 43, 5), ((2, 1), 34, 9),
                                ((1, 1), 52, 9)):
        s = tl.wave_schedule(18 // tile[0], 18 // tile[1])
        assert (len(s), max(map(len, s))) == (waves, widest), tile
    assert 43 * 289 == 12_427 and 162 * 289 == 46_818


# ---------------------------------------------------------------------------
# the plain tiled scan, wave by wave, is the raster scan
# ---------------------------------------------------------------------------

def _toy(sampler, Y=12, X=18, L=16, fsf_size=3, device="cpu", seed=0,
         fwhm_slope=0.0, **kw):
    """A 4 × 6 block field (f = 3) with a masked spaxel; ``fwhm_slope``
    makes the FSF vary with wavelength (rank > 1)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((L, Y, X), np.float32)
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 4, 2, X - 3] = 3.0
    data = truth + 0.1 * rng.standard_normal((L, Y, X)).astype(np.float32)
    mask = np.zeros((Y, X), bool)
    mask[4, 7] = True
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.01),
                             mask=mask, crval=4750.0, cdelt=1.25,
                             device=device)
    inst = tins.Instrument(
        fsf=tins.GaussianFSF(fwhm=0.5, lambda_ref=4750.0,
                             fwhm_slope=fwhm_slope),
        lsf=tins.GaussianLSF(fwhm=2.0))
    cfg = dict(max_iterations=8, burn_in=1, seed=1, fsf_size=fsf_size,
               lsf_width=5, sampler=sampler)
    cfg.update(kw)
    return tsm.make_problem(cube, inst, tsm.RunConfig(**cfg))


def _assert_segments_equal(a, b):
    for name in _FIELDS:
        assert torch.equal(getattr(a.result.state, name),
                           getattr(b.result.state, name)), name
    assert torch.equal(a.accept, b.accept) and torch.equal(a.dchi, b.dchi)
    assert torch.equal(a.result.chi2_trace, b.result.chi2_trace)


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("tile", [(1, 2), (2, 1), (1, 1), (2, 3)])
@pytest.mark.parametrize("n_chains", [1, 2])
def test_wavefront_scan_is_the_raster_scan(sampler, tile, n_chains):
    p = _toy(sampler, engine="torch_tiled", tile=tile)
    assert (p.ny, p.nx) == (4, 6)
    states = (tsm.init_state(p) if n_chains == 1
              else ch.init_chain_states(p, n_chains))
    raster = tl.tiled_segment_reference(p, states, 3, schedule="raster")
    wave = tl.tiled_segment_reference(p, states, 3, schedule="wavefront")
    assert float(raster.accept.sum()) > 0, "nothing drawn; test is vacuous"
    _assert_segments_equal(wave, raster)
    # the default is the wavefront, through the wrapper too
    _assert_segments_equal(tl.tiled_segment(p, states, 3), raster)
    # a schedule that breaks the order is another scan
    if tile != (2, 3):
        k = sw._run_segment(p, states, 3, None, False, mode=sampler, tile=tile,
                            waves=list(reversed(tl.wave_schedule(
                                p.ny // tile[0], p.nx // tile[1]))))
        assert not torch.equal(k.result.state.resid, raster.result.state.resid)


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_tuned_segment_is_the_entry_points_segment(sampler):
    """The measurements' entry runs the plain versions on the CPU, whatever
    the knobs: a tile gives the tiled scan, no tile the whole-cube sweep;
    the entry points themselves take no knob."""
    p = _toy(sampler, engine="torch_tiled", tile=(1, 2))
    s0 = tsm.init_state(p)
    tiled = tl.tiled_segment_reference(p, s0, 2)
    _assert_segments_equal(
        tl.tuned_segment(p, s0, 2, tile=(1, 2), stages=0, lam_b=7), tiled)
    whole = (sw.mh_segment_reference if sampler == "mh"
             else sw.gibbs_segment_reference)(p, s0, 2)
    _assert_segments_equal(tl.tuned_segment(p, s0, 2, stages=0), whole)
    assert not torch.equal(whole.result.state.resid, tiled.result.state.resid)
    with pytest.raises(ValueError, match="does not divide"):
        tl.tuned_segment(p, s0, 1, tile=(3, 2))
    for entry in (tl.tiled_segment, sw.mh_segment, sw.gibbs_segment):
        with pytest.raises(TypeError, match="stages"):
            entry(p, s0, 1, stages=0)


# ---------------------------------------------------------------------------
# gibbs phase (b), slab by slab
# ---------------------------------------------------------------------------

def _phase_inputs(lw, L=300, n=3, seed=0, holes=True, dtype=torch.float32):
    gen = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    qv = gen.random((n, L)) + 0.5
    if holes:
        qv[:, ::7] = 0.0                              # voxels with no data
    return dict(lin0=t(gen.standard_normal((n, L))),
                q=t(gen.random((n, L)) + 0.5), qv=t(qv),
                normal=t(gen.standard_normal((n, L))),
                live=t(qv > 0), lsf=t(gen.random((L, lw))))


@pytest.mark.parametrize("lw", [3, 11])
@pytest.mark.parametrize("lam_b", [1, 7, 64, 299, 300, 1000])
def test_slab_phases_are_the_full_phase_loop(lw, lam_b):
    x = _phase_inputs(lw)
    gacc, emitted = sw.gibbs_phases(**x)
    sg, se = sw.slab_phases_reference(**x, lam_b=lam_b)
    assert torch.equal(sg, gacc) and torch.equal(se, emitted)


@pytest.mark.parametrize("lw", [3, 11])
@pytest.mark.parametrize("side", [0, 1])
def test_slabs_break_one_wavelength_short(lw, side):
    # float64 and every voxel live: a hole can stop the edge's error, and
    # float32 can round its last, smallest step away
    x = _phase_inputs(lw, holes=False, dtype=torch.float64)
    gacc, emitted = sw.gibbs_phases(**x)
    margins = list(rs.window_margins(lw))
    margins[side] -= 1
    broken = []
    for lam_b in range(20, 20 + lw):
        sg, se = sw.slab_phases_reference(**x, lam_b=lam_b,
                                          margins=tuple(margins))
        broken.append(not (torch.equal(sg, gacc) and torch.equal(se, emitted)))
    assert any(broken)


@pytest.mark.parametrize("L, spaxels, n_sm, want", [
    (3681, 324, 132, 921),      # K1 at the full field: 4 slabs (the widest)
    (3681, 10, 132, 263),       # a (1, 2) wave of 5 tiles: 14 slabs
    (3681, 2, 132, 64),         # a (1, 2) raster step: the narrowest, 58
    (600, 4, 132, 60),          # classic K1 at the bench: 10 slabs
    (600, 128, 132, 300),       # 32 chains there: 2 slabs
    (16, 2, 132, 16),           # a toy: one slab
])
def test_phase_slab_rule(L, spaxels, n_sm, want):
    lam_b = sw.phase_slab(L, spaxels, n_sm)
    assert lam_b == want
    assert lam_b <= sw.MAX_PHASE_SLAB


def test_task_clock_labels_match_the_kernel_markers():
    """``python -m deconv3d_tpu_torch.task_phases`` names each clock of the
    measurement build: one label per ``clk.mark(k)`` / ``clk.count(k)`` of
    the step code."""
    from deconv3d_tpu_torch import task_phases as tp

    csrc = Path(tl.__file__).parents[1] / "csrc"
    for mode in ("mh", "gibbs"):
        src = (csrc / f"{mode}_step.cuh").read_text()
        marks = {int(k) for k in re.findall(r"clk\.mark\((\d+)\)", src)}
        counts = {int(k) for k in re.findall(r"clk\.count\((\d+)\)", src)}
        assert marks == set(tp.PHASES[mode]), mode
        assert counts == set(tp.COUNTS[mode]), mode
        assert max(marks | counts) < tp.N_CLOCKS
        for k, phases in tp.PER_TASK[mode].items():
            assert k in counts and set(phases) <= marks
    common = (csrc / "sweep_common.cuh").read_text()
    assert f"kTaskClocks = {tp.N_CLOCKS};" in common


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_problem(sampler, fsf_size, size, L=16, rank=1, **kw):
    """The toy on the card; ``rank`` > 1 asks for a λ-dependent FSF (the
    kernels' any-rank build), rank 1 runs their rank-1 build."""
    p = _toy(sampler, Y=size[0], X=size[1], L=L, fsf_size=fsf_size,
             device="cuda", dtype=np.float32,
             fwhm_slope=0.0 if rank == 1 else 1e-3, **kw)
    assert (p.fsf_spec.shape[0] > 1) == (rank > 1)
    return p


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("fsf_size, size, L, rank", [
    (5, (20, 30), 200, 1), (21, (42, 126), 40, 1), (5, (20, 30), 200, 2)])
@pytest.mark.parametrize("n_chains", [1, 2])
def test_wavefront_kernel_is_the_raster_kernel_on_card(sampler, fsf_size,
                                                       size, L, rank,
                                                       n_chains):
    """The tiled kernel with the wavefront schedule against the raster
    schedule on the Philox draws, tiles of (1, 2) blocks — 12 tiles in 9
    waves at f = 5, 6 in 5 at f = 21 (more patch rows than a block's warps;
    one ring stage) — every output bit-equal; then the raster under every knob:
    synchronous loads, one stage, one slab of the whole spectrum, the
    narrowest slabs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kernel has no CPU mode")
    p = _card_problem(sampler, fsf_size, size, L, rank, tile=(1, 2))
    assert p.config.engine == "cuda_tiled" and p.f == fsf_size
    states = (tsm.init_state(p) if n_chains == 1
              else ch.init_chain_states(p, n_chains))
    counter = tl.tiled_mh if sampler == "mh" else tl.tiled_gibbs
    n0 = counter.launches
    raster = tl.tiled_segment(p, states, 3, schedule="raster")
    wave = tl.tiled_segment(p, states, 3, schedule="wavefront")
    torch.cuda.synchronize()
    assert counter.launches - n0 == 6
    assert float(raster.accept.sum()) > 0, "nothing drawn; test is vacuous"
    _assert_segments_equal(wave, raster)
    knobs = [dict(stages=0), dict(stages=1)]
    if sampler == "gibbs":
        knobs += [dict(lam_b=L), dict(lam_b=8), dict(stages=0, lam_b=33)]
    for kw in knobs:
        _assert_segments_equal(
            tl.tuned_segment(p, states, 3, tile=p.config.tile, **kw), raster)


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("rank", [1, 2])
def test_one_tile_is_the_whole_cube_kernel_on_card(sampler, rank):
    """One tile (ny, nx) of the tiled kernel against classic K1 and the
    resident kernel: the same sweep, bit for bit, under both schedules."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    p = _card_problem(sampler, 5, (20, 20), 200, rank)
    assert p.config.engine == "cuda"
    s0 = tsm.init_state(p)
    seg = sw.mh_segment if sampler == "mh" else sw.gibbs_segment
    classic = seg(p, s0, 3, _classic=True)
    n0 = seg.resident_launches
    _assert_segments_equal(seg(p, s0, 3), classic)
    assert seg.resident_launches - n0 == 3, "the toy must fit the resident kernel"
    for schedule in tl.SCHEDULES:
        one = tl.tiled_segment(p, s0, 3, tile=(p.ny, p.nx), schedule=schedule)
        _assert_segments_equal(one, classic)
    for kw in (dict(stages=0), dict(stages=0, lam_b=200)):
        _assert_segments_equal(tl.tuned_segment(p, s0, 3, **kw), classic)
