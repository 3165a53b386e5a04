"""The resident whole-cube sweep kernel (``csrc/resident_sweep.cu``): its
plan, its dispatch rule and the plain version of its gibbs window step on
the CPU; the kernel itself against classic K1 and the plain sweep on a card.

The resident kernel computes classic K1's function, so its plain version is
K1's (``ops.sweep.mh_segment_reference`` / ``gibbs_segment_reference``,
held against the JAX package in ``test_torch_sweep.py`` and
``test_torch_gibbs.py``).  What is new on the CPU side: whether a problem
fits the card's shared memory (:func:`plan_slabs`), which kernel a sweep
launches (:func:`sweep_kernel`), and the gibbs λ-phases run over one
block's window alone (:func:`windowed_phases_reference`), which must give
the slab's jumps and g of the full-spectrum loop bit for bit.  The tests
marked ``gpu`` decide inside their body whether there is a card; they run
without JAX: ``pytest --noconftest -m gpu``.
"""

import itertools

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

H100 = dict(n_sm=132, smem_optin=232_448)
BENCH = dict(f=17, ny=2, nx=2, L=600, S=1, lw=11)       # MUSE 30×30×600
FIELD_60 = dict(BENCH, ny=4, nx=4, L=3681)               # 60×60×3681
FIELD_300 = dict(BENCH, ny=18, nx=18, L=3681)            # 300×300×3681


# ---------------------------------------------------------------------------
# the plan and the dispatch rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mh", "gibbs"])
def test_the_bench_fits_an_h100(mode):
    assert rs.plan_slabs(C=1, mode=mode, **BENCH, **H100) == (5, 120)
    assert rs.smem_bytes(mode, 1, lam_b=5, **BENCH) <= H100["smem_optin"]


@pytest.mark.parametrize("mode", ["mh", "gibbs"])
def test_the_bench_fits_an_h100_with_positivity(mode):
    """Positivity adds nothing to an MH block (the halo's clean is read
    from global memory) and 2 window arrays to a gibbs block: the bench
    still fits at λ_b = 5 (181 KB gibbs)."""
    assert rs.plan_slabs(C=1, mode=mode, **BENCH, **H100,
                         positivity=True) == (5, 120)
    off = rs.smem_bytes(mode, 1, lam_b=5, **BENCH)
    on = rs.smem_bytes(mode, 1, lam_b=5, **BENCH, positivity=True)
    cs, wd = 4, 5 + 20 + 110
    assert on - off == (0 if mode == "mh" else 4 * 2 * cs * wd)


@pytest.mark.parametrize("mode", ["mh", "gibbs"])
@pytest.mark.parametrize("C, geometry", [(32, BENCH), (1, FIELD_60),
                                         (1, FIELD_300)])
def test_what_does_not_fit_keeps_classic_k1(mode, C, geometry):
    assert rs.plan_slabs(C=C, mode=mode, **geometry, **H100) is None


def test_a_card_with_fewer_sms_gets_a_wider_slab():
    assert rs.plan_slabs(C=1, mode="mh", **BENCH, n_sm=114,
                         smem_optin=H100["smem_optin"]) == (6, 100)
    assert rs.plan_slabs(C=1, mode="mh", **BENCH, n_sm=600,
                         smem_optin=H100["smem_optin"]) == (1, 600)
    # a slab one wavelength wider needs more shared memory, never less
    for mode in ("mh", "gibbs"):
        assert (rs.smem_bytes(mode, 1, lam_b=6, **BENCH)
                > rs.smem_bytes(mode, 1, lam_b=5, **BENCH))


def test_shared_memory_grows_with_the_chains_and_the_window():
    one = rs.smem_bytes("gibbs", 1, lam_b=5, **BENCH)
    two = rs.smem_bytes("gibbs", 2, lam_b=5, **BENCH)
    # a chain more: its resid and clean slabs, its key, and its 4 spaxels'
    # partials, lin, g, geometry (6 ints) and flag in each of the f² colors,
    # and windows
    f, lam_b, cs = 17, 5, 4
    Hp = Wp = f - 1 + 2 * f
    wd = lam_b + sum(rs.window_margins(11))
    assert two - one == 4 * (Hp * Wp * lam_b + 34 * 34 * lam_b + 2
                             + cs * lam_b * (f * 1 + 2) + 7 * f * f * cs
                             + 5 * cs * wd)
    with pytest.raises(ValueError, match="mode"):
        rs.plan_slabs(C=1, mode="direct", **BENCH, **H100)


@pytest.mark.parametrize("tile, classic, plan, want", [
    (None, False, (5, 120), "resident"),
    (None, True, (5, 120), "classic"),       # pinned
    (None, False, None, "classic"),          # does not fit
    ((1, 2), False, (5, 120), "tiled"),
    ((1, 2), True, None, "tiled"),
])
def test_dispatch_rule(tile, classic, plan, want):
    assert rs.sweep_kernel(tile, classic, plan) == want


# ---------------------------------------------------------------------------
# the gibbs window step against the full-spectrum phase loop
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


def _window_equals_full(x, a, b, margins=None):
    gacc, emitted = sw.gibbs_phases(x["lin0"], x["q"], x["qv"], x["normal"],
                                    x["live"], x["lsf"])
    wg, we = rs.windowed_phases_reference(
        x["lin0"], x["q"], x["qv"], x["normal"], x["live"], x["lsf"], a, b,
        margins)
    return torch.equal(wg, gacc[:, a:b]) and torch.equal(we, emitted[:, a:b])


@pytest.mark.parametrize("lw", [3, 11])
@pytest.mark.parametrize("where", ["low_edge", "middle", "high_edge"])
def test_window_gives_the_slab_bit_for_bit(lw, where):
    L = 300
    x = _phase_inputs(lw, L)
    for a in {"low_edge": [0, 1, 3], "middle": range(140, 140 + lw),
              "high_edge": [L - 5, L - 3]}[where]:
        for width in (1, 5):
            b = min(L, a + width)
            assert _window_equals_full(x, a, b), (a, b)
            # a symmetric margin of lw (lw - 1) on both sides holds too
            assert _window_equals_full(x, a, b, (lw * (lw - 1),) * 2), (a, b)


@pytest.mark.parametrize("lw", [3, 11])
@pytest.mark.parametrize("side", [0, 1])
def test_one_wavelength_less_breaks_the_window(lw, side):
    # a hole can stop the edge's error, and float32 can round its last,
    # smallest step away: float64 and every voxel live
    x = _phase_inputs(lw, holes=False, dtype=torch.float64)
    margins = list(rs.window_margins(lw))
    margins[side] -= 1
    broken = [not _window_equals_full(x, a, a + 5, tuple(margins))
              for a in range(140, 140 + lw)]
    assert any(broken)


def test_margins_are_the_derived_ones():
    assert rs.window_margins(11) == (20, 110)
    assert rs.window_margins(3) == (4, 6)


def test_phase_clock_labels_match_the_kernel_markers():
    """``python -m deconv3d_tpu_torch.resident_phases`` names each clock of
    the measurement build: one label per ``PHASE(k)`` marker, k = 0, 1, ...
    in each kernel's color loop."""
    import re
    from pathlib import Path

    from deconv3d_tpu_torch import resident_phases as rp

    src = (Path(rs.__file__).parents[1] / "csrc" / "resident_sweep.cu"
           ).read_text()
    gibbs_at = src.index("resident_gibbs_kernel(ResidentArgs a)")
    mh_at = src.index("resident_mh_kernel(ResidentArgs a)")
    for mode, body in (("mh", src[mh_at:gibbs_at]), ("gibbs", src[gibbs_at:])):
        marks = sorted({int(k) for k in re.findall(r"PHASE\((\d)\);", body)})
        assert marks == list(range(len(rp.PHASES[mode]))), mode


# ---------------------------------------------------------------------------
# the MH decision's reduction order, emulated in float32
# ---------------------------------------------------------------------------

def _halving_tree(v):
    """One lane's sum of each 32-value row as the resident kernel used to
    compute a chunk from shared memory: v[i] += v[i + off], off = 16 … 1."""
    v = v.copy()
    off = 16
    while off:
        v[..., :off] = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


def _warp_sum(lanes):
    """``sweep_common.cuh`` ``warp_sum`` over the last axis (32 lanes):
    ``v += __shfl_down_sync(v, o)`` for o = 16 … 1, where a lane whose
    source lies past the warp reads its own value, then lane 0's value.
    Classic K1 reduces each 32-λ chunk so."""
    x = lanes.copy()
    idx = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., np.where(idx + o < 32, idx + o, idx)]
    return x[..., 0]


def _transpose_sums(v):
    """The resident MH decision's register transpose of ``v`` [..., 32
    chunk slots, 32 lanes]: at offset o = 16 … 1 a lane keeps the o slots
    its bit o selects, ``keep + __shfl_xor_sync(send, o)``.  Returns [...,
    32 lanes], lane q holding chunk q's sum."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        up = (lane & o) != 0
        send = np.where(up, v[..., :o, :], v[..., o:2 * o, :])
        keep = np.where(up, v[..., o:2 * o, :], v[..., :o, :])
        v = keep + send[..., lane ^ o]
    return v[..., 0, :]


def _dchi_staged(shares, chunk_sum):
    """Δχ² of each row of per-λ shares: each 32-λ chunk (zero past L)
    reduced by ``chunk_sum`` over its last axis, lane l summing chunks l,
    l + 32, … in order, then ``warp_sum`` of the lanes."""
    n, L = shares.shape
    P = -(-L // 32)
    chunks = np.zeros((n, P * 32), np.float32)
    chunks[:, :L] = shares
    sums = chunk_sum(chunks.reshape(n, P, 32))
    lanes = np.zeros((n, 32), np.float32)
    for lane in range(32):
        for q in range(lane, P, 32):
            lanes[:, lane] = lanes[:, lane] + sums[:, q]
    return _warp_sum(lanes)


def _dchi_in_registers(shares):
    """The resident kernel's pass: for each group of 32 chunks q0 … q0 +
    31, lane l loads λ = 32 q + l of each (zero past L), the transpose
    leaves chunk q0 + l's sum in lane l, which adds it where q0 + l < P;
    then ``warp_sum`` of the lanes."""
    n, L = shares.shape
    P = -(-L // 32)
    dchi = np.zeros((n, 32), np.float32)
    for q0 in range(0, P, 32):
        v = np.zeros((n, 32, 32), np.float32)         # [row, slot, lane]
        for i in range(32):
            seg = shares[:, (q0 + i) * 32:(q0 + i + 1) * 32]
            v[:, i, :seg.shape[1]] = seg
        mine = _transpose_sums(v)
        live = q0 + np.arange(32) < P
        dchi[:, live] = dchi[:, live] + mine[:, live]
    return _warp_sum(dchi)


def _awkward_shares(n, L, seed):
    """float32 shares of mixed magnitudes and signs, with signed zeros:
    whole zero chunks of either sign, stray −0.0, and large values that
    cancel, so that a different association shows in the bits."""
    gen = np.random.default_rng(seed)
    x = gen.standard_normal((n, L)) * 10.0 ** gen.uniform(-20, 20, (n, L))
    x = x.astype(np.float32)
    x[gen.random((n, L)) < 0.1] = -0.0
    x[gen.random((n, L)) < 0.05] = 0.0
    x[0] = -0.0                                       # a row of −0.0
    x[1, :32] = -0.0                                  # a chunk of −0.0
    x[2, 32:64] = 0.0
    x[3, ::2] = 1e30                                  # cancellation
    x[3, 1::2] = -1e30
    return x


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("reduction", ["warp_sum", "transpose"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_reductions_are_the_one_lane_halving_tree(reduction, seed):
    """32 chunks of 32 shares each, summed by ``warp_sum``'s shuffles
    (lane 0; classic K1) or by the register transpose (lane q; the resident
    kernel), equal the one-lane halving tree bit for bit: each chunk meets
    the same pairs at every level, and float addition commutes."""
    x = _awkward_shares(64, 32 * 32, seed).reshape(-1, 32, 32)
    want = _halving_tree(x)                           # [row, chunk]
    got = _warp_sum(x) if reduction == "warp_sum" else _transpose_sums(x)
    assert np.array_equal(_bits(got), _bits(want))
    # a sum in another order differs somewhere: the check can fail
    serial = np.zeros(want.shape, np.float32)
    for i in range(32):
        serial = serial + x[..., i]
    assert not np.array_equal(_bits(serial), _bits(want))


@pytest.mark.parametrize("L", [600, 1100, 32 * 35])   # P = 19, 35, 35
@pytest.mark.parametrize("seed", [0, 1])
def test_dchi_in_registers_equals_the_staged_order(L, seed):
    """The resident kernel's Δχ² (chunks reduced in registers, lane q
    adding chunk q, then q + 32) equals the staging pass's and classic
    K1's bit for bit, P below and above 32 and L past the last full
    chunk."""
    shares = _awkward_shares(48, L, seed)
    got = _dchi_in_registers(shares)
    assert np.array_equal(_bits(got), _bits(_dchi_staged(shares, _halving_tree)))
    assert np.array_equal(_bits(got), _bits(_dchi_staged(shares, _warp_sum)))
    assert _bits(got)[0] == 0                         # +0.0 from −0.0s
    # the lane-strided order matters: chunk sums added in one run differ
    P = -(-L // 32)
    pad = np.zeros((len(shares), P * 32), np.float32)
    pad[:, :L] = shares
    sums = _halving_tree(pad.reshape(len(shares), P, 32))
    run = np.zeros(len(shares), np.float32)
    for q in range(P):
        run = run + sums[:, q]
    assert not np.array_equal(_bits(run), _bits(got))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _make_toy(seed=42, L=16, Y=6, X=6, fsf_size=5, sampler="mh",
              device="cpu", **config):
    gen = np.random.default_rng(seed)
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
    cfg = sm.RunConfig(fsf_size=fsf_size, lsf_width=5, dtype=np.float32,
                       seed=4, sampler=sampler, **config)
    return sm.make_problem(cube, inst, cfg)


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_classic_pin_leaves_the_cpu_on_the_plain_sweep(sampler):
    p = _make_toy(sampler=sampler)
    s0 = sm.init_state(p)
    seg = sw.mh_segment if sampler == "mh" else sw.gibbs_segment
    ref = (sw.mh_segment_reference if sampler == "mh"
           else sw.gibbs_segment_reference)
    counts = (seg.launches, seg.resident_launches)
    pinned = seg(p, s0, 2, _classic=True)
    plain = ref(p, s0, 2)
    assert (seg.launches, seg.resident_launches) == counts
    for name in ("resid", "clean", "log_scale", "chi2"):
        assert torch.equal(getattr(pinned.result.state, name),
                           getattr(plain.result.state, name))
    assert torch.equal(pinned.accept, plain.accept)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("fsf_size, L", [(5, 200), (21, 40), (5, 1100)])
@pytest.mark.parametrize("n_chains", [1, 2])
def test_resident_matches_classic_and_plain_on_card(sampler, fsf_size, L,
                                                    n_chains):
    """The resident kernel against classic K1 on the Philox draws (every
    output bit-equal) and against the plain sweep on injected uniforms
    (MH untied; tolerances of the classic kernels' tests).  L = 200 at
    f = 5 and L = 40 at f = 21 put 100 and 40 slabs on the card, so the
    gibbs windows are cut on both sides; f = 21 has more patch rows than
    classic K1's 18 warps.  L = 1100 gives 35 chunks of 32 λ, so the MH
    decision's warp loops over two groups of chunks; f = 5 has 5 warps, so
    at 2 chains (8 (chain, spaxel) pairs a color) a warp takes two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the resident kernel has no CPU mode")
    p = _make_toy(L=L, fsf_size=fsf_size, sampler=sampler, device="cuda")
    assert p.f == fsf_size
    lw = int(p.lsf.shape[1])
    plan = rs.plan_slabs(n_chains, p.f, p.ny, p.nx, p.L,
                         int(p.fsf_spec.shape[0]), lw, sampler,
                         *rs.device_limits("cuda"))
    assert plan is not None, "the toy must fit the resident kernel"
    states = ch.init_chain_states(p, n_chains)
    seg = sw.mh_segment if sampler == "mh" else sw.gibbs_segment
    n0 = (seg.launches, seg.resident_launches)
    res = seg(p, states, 3)
    cla = seg(p, states, 3, _classic=True)
    torch.cuda.synchronize()
    assert (seg.launches - n0[0], seg.resident_launches - n0[1]) == (3, 3)
    for name in ("resid", "clean", "log_scale", "chi2", "n_accept"):
        assert torch.equal(getattr(res.result.state, name),
                           getattr(cla.result.state, name)), name
    assert torch.equal(res.accept, cla.accept)
    assert torch.equal(res.dchi, cla.dchi)
    assert float(res.accept.sum()) > 0, "nothing accepted; test is vacuous"

    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(9).random(
        (2, n_chains, p.n_colors, p.ny * p.nx, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, plain = sw.untie_uniforms(p, states, 2, u)
    else:
        plain = sw.gibbs_segment_reference(p, states, 2, u)
    kern = seg(p, states, 2, u, record_uniforms=True)
    assert torch.equal(kern.uniforms, u)
    assert torch.equal(plain.accept, kern.accept)
    for name in ("resid", "clean"):
        ref = getattr(plain.result.state, name)
        torch.testing.assert_close(getattr(kern.result.state, name), ref,
                                   rtol=0, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_resident_smem_formula_is_the_kernels_on_card():
    """``ops/resident.py::smem_bytes`` against the layout the kernel
    carves (``resident_smem_bytes``), and the scratch sizes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the resident kernel has no CPU mode")
    from deconv3d_tpu_torch._build import load_library

    lib = load_library()
    for mode in ("mh", "gibbs"):
        for C, geo in ((1, BENCH), (2, BENCH), (3, dict(BENCH, f=21, L=40)),
                       (1, dict(BENCH, f=5, ny=4, nx=3, S=3, lw=5, L=200))):
            args = (geo["f"], geo["ny"], geo["nx"], geo["L"], geo["S"],
                    geo["lw"])
            for lam_b, pos in itertools.product((1, 5), (False, True)):
                assert lib.resident_smem_bytes(
                    int(mode == "gibbs") | 2 * pos, C, *args,
                    lam_b) == rs.smem_bytes(
                    mode, C, *args, lam_b, pos), (mode, C, geo, lam_b, pos)


@pytest.mark.gpu
def test_trunc_normal_kernel_matches_plain_on_card():
    """``trunc_normal_kernel`` (the sweep kernels' device functions,
    elementwise) against the plain transform, in float64 on the same
    float32 inputs, over α ∈ [−5, 1e4] and uniforms in [2⁻²⁴, 1 − 2⁻²⁴]:
    max |Δz| / max(1, |z|) ≤ 1e-4 wherever float32 resolves the draw —
    the tail, and the body where 1 − p ≥ 2⁻¹² (nearer p = 1 an ulp of p
    moves z by more, and p may round to 1, which caps the draw at α + 9);
    there every draw lies in [α, α + 9]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from deconv3d_tpu_torch.ops import truncnorm as tn

    alpha = np.concatenate([np.linspace(-5.0, 10.0, 301),
                            2.0 + np.geomspace(1e-6, 1e-2, 20),
                            np.geomspace(10.0, 1e4, 100)])
    u = np.concatenate([np.geomspace(2.0**-24, 0.5, 40),
                        1.0 - np.geomspace(2.0**-24, 0.5, 40)])
    a, u1 = (torch.tensor(x.ravel(), dtype=torch.float32)
             for x in np.meshgrid(alpha, u))
    u2 = u1.flip(0).contiguous()
    n0 = tn.trunc_normal.launches
    got = tn.trunc_normal(a.cuda(), u1.cuda(), u2.cuda()).cpu()
    assert tn.trunc_normal.launches - n0 == 1
    want = tn.transform_uniforms(a.double(), u1.double(), u2.double())
    err = (got.double() - want).abs() / want.abs().clamp(min=1.0)
    one_minus_p = (1.0 - torch.special.ndtr(a.double())) * (1.0 - u1.double())
    resolved = (a > tn.TAIL_SWITCH) | (one_minus_p >= 2.0**-12)
    assert torch.isfinite(got).all()
    assert float(err[resolved].max()) <= 1e-4
    edge = ~resolved
    assert bool(((got[edge] >= a[edge]) & (got[edge] <= a[edge] + 9.0)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
@pytest.mark.parametrize("n_chains", [1, 2])
def test_positivity_kernels_match_on_card(sampler, n_chains):
    """With positivity (from a start at the data, negative voxels
    included) the resident kernel, classic K1 and the tiled kernel in one
    tile are bit-equal on the Philox draws and keep the orthant, and the
    resident kernel matches the plain sweep on injected uniforms (MH
    untied; the tolerances of the classic kernels' tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    from deconv3d_tpu_torch.ops import tiled

    kw = dict(sampler=sampler, positivity=True, initial="data")
    p = _make_toy(device="cuda", **kw)
    states = ch.init_chain_states(p, n_chains)
    seg = sw.mh_segment if sampler == "mh" else sw.gibbs_segment
    n0 = seg.resident_launches
    res = seg(p, states, 3)
    cla = seg(p, states, 3, _classic=True)
    one = tiled.tiled_segment(p, states, 3, tile=(p.ny, p.nx))
    torch.cuda.synchronize()
    assert seg.resident_launches - n0 == 3
    for name in ("resid", "clean", "chi2"):
        a = getattr(res.result.state, name)
        assert torch.equal(a, getattr(cla.result.state, name)), name
        assert torch.equal(a, getattr(one.result.state, name)), name
    moved = res.result.state.clean != states.clean
    assert bool(moved.any()) and float(res.result.state.clean[moved].min()) >= 0
    cpu_p = _make_toy(**kw)
    cpu_s = sm.init_state(cpu_p)
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = torch.rand((2, p.n_colors, p.ny * p.nx, *per),
                   generator=torch.Generator().manual_seed(1)).clamp(
        2.0**-24, 1 - 2.0**-24)
    if sampler == "mh":
        u, ref = sw.untie_uniforms(cpu_p, cpu_s, 2, u)
    else:
        ref = sw.gibbs_segment_reference(cpu_p, cpu_s, 2, u)
    got = seg(p, sm.init_state(p), 2, u.cuda())
    assert torch.equal(got.accept.cpu(), ref.accept)
    for name in ("resid", "clean"):
        want = getattr(ref.result.state, name)
        np.testing.assert_allclose(
            getattr(got.result.state, name).cpu().numpy(), want.numpy(),
            rtol=0, atol=1e-4 * float(want.abs().max()), err_msg=name)
