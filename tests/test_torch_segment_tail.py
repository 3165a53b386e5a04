"""A segment's tail (``ops/sweep.py::_segment_tail``): the committed Δχ² of
every sweep and chain reduced in float64 (a run of sweeps at a time, within
``TAIL_CHUNK_BYTES``), the Kahan scan over the
sweeps (``chi2_scan``: ``csrc/chi2_scan.cu`` on a card, the plain loop
``chi2_scan_reference`` on the CPU) and the traces as whole-segment ops.

The tail must give what the per-sweep loop it replaced gave, kept here as
:func:`_per_sweep_tail`: on the CPU bit for bit, inputs alone and inside
whole segments (mh, gibbs, gibbs_block; one and three chains; an incoming
compensation that is not 0; ``track_variance``; two shards).  The plain
scan keeps the compensation on sums that a float32 running sum loses.  The
tests marked ``gpu`` decide inside their body whether there is a card; they
run without JAX: ``pytest --noconftest -m gpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import resident as rs
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.parallel import Mesh
from deconv3d_tpu_torch.parallel import sweep_sharded as ss


def _per_sweep_tail(mode, accept, dchi, flux, mon, order, chi2, chi2c,
                    n_valid):
    """The tail as one pass of small ops per sweep (what ``_segment_tail``
    replaced), with ``_segment_tail``'s arguments and result."""
    n, C, K = mon.shape
    dt, f32, dev = mon.dtype, torch.float32, dchi.device
    chi2_t, flux_t, mon_tr = [], [], []
    for s in range(n):
        committed = dchi[s].double()
        if mode == "mh":
            committed = committed * accept[s].double()
        y = committed.sum(dim=(1, 2)).to(f32) - chi2c
        t = chi2 + y
        chi2c = (t - chi2) - y
        chi2 = t
        chi2_t.append(chi2)
        flux_t.append(flux[s])
        vals = torch.empty((C, K), dtype=dt, device=dev)
        vals[:, order] = mon[s]
        mon_tr.append(vals)
    acc_sweep = accept.sum(dim=(2, 3)).T
    n_acc = acc_sweep.sum(dim=1).to(f32)
    if mode != "mh":
        n_prop = n_acc
        acc_trace = torch.ones_like(acc_sweep)
    else:
        n_prop = torch.full_like(n_acc, float(n) * n_valid)
        acc_trace = acc_sweep / max(n_valid, 1.0)
    return sw._Tail(torch.stack(chi2_t, dim=1), chi2, chi2c, acc_trace,
                    torch.stack(flux_t, dim=1),
                    torch.stack(mon_tr, dim=1).to(dt), n_acc, n_prop)


def _tail_inputs(mode, C, dtype=torch.float32, n=40, colors=9, nij=6, K=7,
                 seed=0, device="cpu"):
    """Stacked outputs of ``n`` sweeps as a segment leaves them: MH accept
    flags or gibbs voxel counts, Δχ² of both signs, flux, monitored voxels
    in a shuffled order, and an incoming Kahan pair whose compensation is
    not 0."""
    gen = torch.Generator().manual_seed(seed)
    shape = (n, C, colors, nij)
    if mode == "mh":
        accept = (torch.rand(shape, generator=gen) < 0.3).to(dtype)
    else:
        accept = torch.randint(0, 17, shape, generator=gen).to(dtype)
    dchi = (torch.randn(shape, generator=gen) * 3.0).to(dtype)
    flux = torch.randn((n, C), generator=gen) * 50.0
    mon = torch.randn((n, C, K), generator=gen).to(dtype)
    order = torch.randperm(K, generator=gen)
    chi2 = 1.0e5 + 1.0e3 * torch.rand(C, generator=gen)
    chi2c = 1.0e-3 * torch.randn(C, generator=gen)
    return tuple(t.to(device) for t in (accept, dchi, flux, mon, order,
                                        chi2, chi2c))


def _assert_same(a, b, what=""):
    """Equal bit for bit, with the same dtype and shape."""
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _assert_same_result(new, old):
    for field in ("chi2_trace", "accept_trace", "flux_trace",
                  "monitor_trace"):
        _assert_same(getattr(new, field), getattr(old, field), field)
    for fld in dataclasses.fields(new.state):
        _assert_same(getattr(new.state, fld.name),
                     getattr(old.state, fld.name), fld.name)


@pytest.mark.parametrize("mode", ["mh", "gibbs"])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tail_equals_the_per_sweep_tail(mode, C, dtype):
    args = _tail_inputs(mode, C, dtype)
    accept, dchi, flux, mon, order, chi2, chi2c = args
    new = sw._segment_tail(mode, accept, dchi, flux, mon, order, chi2,
                           chi2c, 23.0)
    old = _per_sweep_tail(mode, accept, dchi, flux, mon, order, chi2,
                          chi2c, 23.0)
    for name in sw._Tail._fields:
        _assert_same(getattr(new, name), getattr(old, name), name)
    assert float(new.chi2_comp.abs().max()) > 0, "compensation stayed 0"


def _toy_cube(device="cpu", L=16, seed=42):
    """A 6×6 toy cube of two point sources and its instrument."""
    gen = np.random.default_rng(seed)
    Y = X = 6
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cube0 = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=5, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = (conv + 0.1 * gen.standard_normal(conv.shape)).astype(np.float32)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.01),
                             crval=4750.0, cdelt=1.25, dtype=np.float32,
                             device=device)
    return cube, inst


def _toy(sampler="mh", device="cpu", L=16, **config):
    cube, inst = _toy_cube(device, L)
    cfg = sm.RunConfig(fsf_size=5, lsf_width=5, dtype=np.float32, seed=4,
                       sampler=sampler, **config)
    return sm.make_problem(cube, inst, cfg)


def _with_compensation(states):
    """``states`` with an incoming Kahan compensation that is not 0."""
    return dataclasses.replace(states, chi2_comp=states.chi2_comp + 3e-3)


SEGMENTS = {"mh": sw.mh_segment_reference,
            "gibbs": sw.gibbs_segment_reference,
            "gibbs_block": sw.gibbs_block_segment_reference}


@pytest.mark.parametrize("mode", ["mh", "gibbs"])
@pytest.mark.parametrize("sweeps_per_run", [1, 3, 7])
def test_tail_in_runs_of_sweeps_equals_the_per_sweep_tail(monkeypatch, mode,
                                                          sweeps_per_run):
    """The committed Δχ² reduced a run of sweeps at a time (a long segment
    of a big field; the last run shorter) gives the per-sweep tail's bits."""
    args = _tail_inputs(mode, 3, n=40)
    accept, dchi = args[:2]
    per_sweep = dchi[0].numel() * (8 + dchi.element_size() * (mode == "mh"))
    monkeypatch.setattr(sw, "TAIL_CHUNK_BYTES", sweeps_per_run * per_sweep)
    new = sw._segment_tail(mode, *args, 900.0)
    old = _per_sweep_tail(mode, *args, 900.0)
    for field, a, b in zip(sw._Tail._fields, new, old):
        _assert_same(a, b, field)


@pytest.mark.parametrize("mode", ["mh", "gibbs", "gibbs_block"])
@pytest.mark.parametrize("n_chains", [1, 3])
@pytest.mark.parametrize("track_variance", [False, True])
def test_segment_equals_the_per_sweep_tail(monkeypatch, mode, n_chains,
                                           track_variance):
    """A whole segment (one chain unstacked, or three stacked) with the
    tail against the same segment with the per-sweep tail: every trace
    and every field of the new state bit for bit."""
    p = _toy(sampler=mode, track_variance=track_variance)
    states = _with_compensation(
        sm.init_state(p) if n_chains == 1
        else ch.init_chain_states(p, n_chains))
    new = SEGMENTS[mode](p, states, 5).result
    monkeypatch.setattr(sw, "_segment_tail", _per_sweep_tail)
    old = SEGMENTS[mode](p, states, 5).result
    _assert_same_result(new, old)
    assert old.chi2_trace.shape[-1] == 5


@pytest.mark.parametrize("mode", ["mh", "gibbs"])
def test_sharded_segment_equals_the_per_sweep_tail(monkeypatch, mode):
    """Two CPU shards (``parallel/sweep_sharded.py``): the gathered outputs
    through the tail against the per-sweep tail, bit for bit."""
    p = _toy(sampler=mode)
    s0 = _with_compensation(sm.init_state(p))
    mesh = Mesh([torch.device("cpu")] * 2, ("sp",))
    new = ss.run_sweeps_sharded(p, s0, 4, mesh)
    monkeypatch.setattr(sw, "_segment_tail", _per_sweep_tail)
    old = ss.run_sweeps_sharded(p, s0, 4, mesh)
    _assert_same_result(new, old)


def test_plain_scan_keeps_the_compensation():
    """Small Δχ² of both signs on large χ² over 1000 sweeps: the plain scan
    stays within an ulp of the float64 running sum at every sweep, where
    a float32 running sum drifts by many (at 3.3e7 it moves not at all)."""
    gen = np.random.default_rng(3)
    n = 1000
    committed = (gen.uniform(-1.0, 1.0, (n, 2)) * 0.37).astype(np.float32)
    chi2_0 = np.array([1.0e6, 3.3e7], dtype=np.float32)
    trace, chi2, comp = sw.chi2_scan_reference(
        torch.as_tensor(committed), torch.as_tensor(chi2_0), torch.zeros(2))
    exact = chi2_0 + np.cumsum(committed.astype(np.float64), axis=0)   # [n, 2]
    ulp = np.spacing(exact.astype(np.float32))
    kahan_err = np.abs(trace.numpy().T.astype(np.float64) - exact)
    assert np.all(kahan_err <= ulp), kahan_err.max(axis=0)
    assert float(chi2[0]) == float(trace[0, -1])
    naive, naive_err = chi2_0.copy(), np.zeros(2)
    for s in range(n):
        naive = naive + committed[s]
        naive_err = np.maximum(naive_err, np.abs(naive - exact[s]))
    assert naive_err[0] >= 4 * ulp[-1, 0], naive_err[0] / ulp[-1, 0]
    assert naive[1] == chi2_0[1]                  # every step rounds away
    assert np.abs(exact[:, 1] - chi2_0[1]).max() > 2 * ulp[-1, 1]
    assert abs(float(chi2[1]) - float(comp[1]) - exact[-1, 1]) < ulp[-1, 1]


def test_scan_takes_the_plain_loop_on_the_cpu():
    args = _tail_inputs("mh", 3)
    committed = args[1].double().sum(dim=(2, 3)).float()
    before = sw.chi2_scan.launches
    got = sw.chi2_scan(committed, args[5], args[6])
    want = sw.chi2_scan_reference(committed, args[5], args[6])
    assert sw.chi2_scan.launches == before
    for a, b in zip(got, want):
        _assert_same(a, b)
    assert got[0].shape == (3, committed.shape[0])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 1000])
@pytest.mark.parametrize("C", [1, 32])
def test_scan_kernel_is_the_plain_scan_on_card(n, C):
    dev = _card()
    gen = torch.Generator().manual_seed(n * 100 + C)
    committed = (torch.randn((n, C), generator=gen)
                 * torch.logspace(-3, 3, n)[:, None]).float()
    chi2 = 1.0e4 + 1.0e6 * torch.rand(C, generator=gen)
    comp = 1.0e-2 * torch.randn(C, generator=gen)
    before = sw.chi2_scan.launches
    got = sw.chi2_scan(committed.to(dev), chi2.to(dev), comp.to(dev))
    want = sw.chi2_scan_reference(committed, chi2, comp)
    assert sw.chi2_scan.launches == before + 1
    for name, a, b in zip(("trace", "chi2", "comp"), got, want):
        _assert_same(a.cpu(), b, name)


@pytest.mark.gpu
def test_one_scan_launch_per_segment_on_card():
    dev = _card()
    p = _toy(device=dev, L=200)
    s = sm.init_state(p)
    before = sw.chi2_scan.launches
    for _ in range(3):
        s = sw.mh_segment(p, s, 4).result.state
    assert sw.chi2_scan.launches == before + 3
    run = d3.Run(*_toy_cube(dev, L=200), max_iterations=12, burn_in=4,
                 fsf_size=5, lsf_width=5, seed=3, device="cuda",
                 segment_size=4)
    before = sw.chi2_scan.launches
    run.run()
    assert sw.chi2_scan.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["mh", "gibbs"])
def test_segment_tail_never_syncs_on_card(mode):
    dev = _card()
    accept, dchi, flux, mon, order, chi2, chi2c = _tail_inputs(
        mode, 3, n=1000, colors=289, nij=4, device=dev)
    sw._segment_tail(mode, accept, dchi, flux, mon, order, chi2, chi2c,
                     900.0)                      # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tail = sw._segment_tail(mode, accept, dchi, flux, mon, order,
                                chi2, chi2c, 900.0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = _per_sweep_tail(mode, accept, dchi, flux, mon, order, chi2,
                           chi2c, 900.0)
    torch.testing.assert_close(tail.chi2_trace, want.chi2_trace, rtol=1e-6,
                               atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["mh", "gibbs"])
def test_segment_tail_holds_one_run_of_sweeps_on_card(mode):
    """A 128-sweep segment of the 300×300 field's shape (289 colors of 324
    spaxels): the tail's card peak above its inputs stays within
    ``TAIL_CHUNK_BYTES`` (and 1 MiB), where float64 copies of the whole
    segment's Δχ² take 96 MB (gibbs) to 192 MB (MH)."""
    dev = _card()
    accept, dchi, flux, mon, order, chi2, chi2c = _tail_inputs(
        mode, 1, n=128, colors=289, nij=324, device=dev)
    args = (mode, accept, dchi, flux, mon, order, chi2, chi2c, 900.0)
    sw._segment_tail(*args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sw._segment_tail(*args)
    torch.cuda.synchronize()
    assert dchi.numel() * 8 > sw.TAIL_CHUNK_BYTES + 2**20
    assert torch.cuda.max_memory_allocated() - base <= (
        sw.TAIL_CHUNK_BYTES + 2**20)


@pytest.mark.gpu
@pytest.mark.parametrize("n_chains", [1, 2])
def test_resident_segment_matches_the_per_sweep_tail_on_card(monkeypatch,
                                                              n_chains):
    """A resident ``mh`` segment of 200 sweeps with the tail against the
    same segment with the per-sweep tail (the kernel's sweeps are
    deterministic, so both see the same outputs).  Everything but χ² is
    bit-equal.  χ² to rtol 1e-6: on the card the float64 sums of all
    sweeps at once are reduced in another order than one sweep's alone,
    and in rare sweeps round to another float32."""
    dev = _card()
    p = _toy(device=dev, L=200)
    assert rs.plan_slabs(n_chains, p.f, p.ny, p.nx, p.L,
                         int(p.fsf_spec.shape[0]), int(p.lsf.shape[1]), "mh",
                         *rs.device_limits(dev)) is not None
    states = _with_compensation(ch.init_chain_states(p, n_chains))
    before = sw.mh_segment.resident_launches
    new = sw.mh_segment(p, states, 200).result
    assert sw.mh_segment.resident_launches == before + 200
    monkeypatch.setattr(sw, "_segment_tail", _per_sweep_tail)
    old = sw.mh_segment(p, states, 200).result
    torch.testing.assert_close(new.chi2_trace, old.chi2_trace, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(new.state.chi2, old.state.chi2, rtol=1e-6,
                               atol=0)
    for field in ("accept_trace", "flux_trace", "monitor_trace"):
        _assert_same(getattr(new, field), getattr(old, field), field)
    for name in ("clean", "resid", "n_accept", "n_propose", "sum_clean",
                 "sum_sq", "log_scale", "n_kept", "sweep"):
        _assert_same(getattr(new.state, name), getattr(old.state, name), name)
    assert float(new.accept_trace.sum()) > 0, "nothing accepted"
