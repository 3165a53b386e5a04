"""λ-chunking in the port: ``full_chi2_chunked`` and ``lambda_chunk``.

Twins of the JAX package's ``tests/test_rebaseline.py::
test_full_chi2_chunked_*`` and ``tests/test_sampler.py::
test_lambda_chunk*``: the chunked from-scratch χ² against the monolithic
one (any chunking, λ-independent and chromatic banks) and against the JAX
``full_chi2_chunked`` on a problem carried across with ``interop``;
``full_chi2``'s switch; the ``lambda_chunk=None`` rule against the JAX
``make_problem``'s; the plain sweeps with λ-chunked slab reads and commits
against the unchunked ones on the same Philox draws.

Tolerances: the χ² at rel 5e-6, the JAX test's: both paths sum the
squared residuals in float32 (the port's chunked one each chunk's sum,
added in float64), in other orders, and the monolithic spectral stage is
a matmul below 2048 planes where the chunked one is ``lw`` multiply-adds.
The sweeps: bit-equal with one chunk (``lambda_chunk =
L``, the unchunked code path) and on the whole-cube ``'torch'`` engine at
these shapes; elsewhere torch's ``einsum`` picks its contraction order by
the operands' shape, so a smaller slab can round the last bit of ``lin``
differently (measured ≤ 6e-15): ≤ 1e-12 relative in float64 there (1e-6
for the float32 χ² and flux), with every decision equal.
"""

import dataclasses
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

import jax

from deconv3d_tpu import Cube as JCube
from deconv3d_tpu import instruments as jins
from deconv3d_tpu import sampler as jsm
from deconv3d_tpu_torch import Cube as TCube
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as tsm
from deconv3d_tpu_torch.parallel import Mesh
from deconv3d_tpu_torch.parallel import sweep_sharded as ss

L = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toys of a few thousand voxels: torch's intra-op threads cost more
    than they give, and under a parallel test run they contend with the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, L=L, Y=20, X=10, noise=0.2):
    rng = np.random.default_rng(seed)
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 2, 2] = 3.0
    return truth + noise * rng.standard_normal(truth.shape), noise


def _problem(sampler="mh", lambda_chunk=0, **cfg):
    data, noise = _data()
    cube = TCube.from_data(data, variance=np.full_like(data, noise**2),
                           crval=4750.0, cdelt=1.25, dtype=np.float64)
    inst = tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                           lsf=tins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    return tsm.make_problem(cube, inst, tsm.RunConfig(
        seed=3, sampler=sampler, fsf_size=5, lsf_width=5, dtype=np.float64,
        lambda_chunk=lambda_chunk, **cfg), device="cpu")


def _close(got, want, rtol):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (
        float(got), float(want))


# ---------------------------------------------------------------------------
# full_chi2_chunked
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moved():
    """A float64 MH problem 3 sweeps in (the JAX test's state)."""
    p = _problem()
    return p, tsm.run_sweeps(p, tsm.init_state(p), 3).state


@pytest.mark.parametrize("chunk", [1, 3, 7, 16, 64])
def test_full_chi2_chunked_matches_monolithic(moved, chunk):
    p, st = moved
    assert p.L * p.Y * p.X * 4 <= tsm.FULL_CHI2_CHUNK_BYTES
    _close(tsm.full_chi2_chunked(p, st, chunk=chunk), tsm.full_chi2(p, st),
           5e-6)


@pytest.fixture(scope="module")
def chromatic():
    """λ-dependent FSF and LSF banks ([L, f, f] / [L, lw]) on 13 planes."""
    L, Y, X = 13, 6, 6
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    inst = tins.Instrument(
        fsf=tins.MoffatFSF(fwhm=0.45, lambda_ref=4750.0, fwhm_slope=4e-3),
        lsf=tins.MUSELSF(), pixel_scale=0.2)
    cube = TCube.from_data(truth + 0.2, variance=np.full_like(truth, 0.04),
                           crval=4750.0, cdelt=1.25, dtype=np.float64)
    p = tsm.make_problem(cube, inst, tsm.RunConfig(
        max_iterations=20, burn_in=2, seed=0, fsf_size=5, lsf_width=5,
        dtype=np.float64), device="cpu")
    assert p.fsf.shape[0] == L and p.lsf.shape[0] == L
    assert not torch.equal(p.fsf[0], p.fsf[-1])
    return p, tsm.run_sweeps(p, tsm.init_state(p), 2).state


@pytest.mark.parametrize("chunk", [1, 4, 5, 13, 99])
def test_full_chi2_chunked_matches_chromatic(chromatic, chunk):
    p, st = chromatic
    _close(tsm.full_chi2_chunked(p, st, chunk=chunk), tsm.full_chi2(p, st),
           5e-6)


@pytest.fixture(scope="module")
def jax_carried():
    """A JAX float64 MH problem 3 sweeps in, and the same problem and
    state carried across with ``interop``."""
    jax.config.update("jax_enable_x64", True)
    data, noise = _data(seed=5)
    cube = JCube.from_data(data, variance=np.full_like(data, noise**2),
                           crval=4750.0, cdelt=1.25, dtype=np.float64)
    inst = jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                           lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cfg = jsm.RunConfig(max_iterations=6, burn_in=2, seed=2, fsf_size=5,
                        lsf_width=5, dtype=np.float64)
    jp = jsm.make_problem(cube, inst, cfg)
    js = jsm.run_sweeps(jp, jsm.init_state(jp), 3).state
    d = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    tp = interop.problem_from_numpy(
        {k: None if v is None else np.asarray(v) for k, v in d.items()
         if k != "config"},
        tsm.RunConfig(fsf_size=5, lsf_width=5, dtype=np.float64))
    ts = interop.state_from_numpy(
        {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js)}, dtype=torch.float64)
    return jp, js, tp, ts


@pytest.mark.parametrize("chunk", [1, 7, 256])
def test_full_chi2_chunked_matches_jax(jax_carried, chunk):
    """The port's chunked χ² == the JAX package's, on its own problem."""
    jp, js, tp, ts = jax_carried
    want = float(jsm.full_chi2_chunked(jp, js, chunk=chunk))
    _close(tsm.full_chi2_chunked(tp, ts, chunk=chunk), want, 5e-6)
    _close(tsm.full_chi2(tp, ts), float(jsm.full_chi2(jp, js)), 5e-6)


def test_full_chi2_switches_above_the_threshold(moved, monkeypatch):
    """``full_chi2`` routes to the chunked path above
    ``FULL_CHI2_CHUNK_BYTES`` (L·Y·X·4) and not at or below it."""
    p, st = moved
    calls = []
    chunked = tsm.full_chi2_chunked

    def spy(problem, state, chunk=256):
        calls.append(chunk)
        return chunked(problem, state, chunk)

    monkeypatch.setattr(tsm, "full_chi2_chunked", spy)
    mono = tsm.full_chi2(p, st)
    assert calls == []
    monkeypatch.setattr(tsm, "FULL_CHI2_CHUNK_BYTES", p.L * p.Y * p.X * 4)
    assert float(tsm.full_chi2(p, st)) == float(mono) and calls == []
    monkeypatch.setattr(tsm, "FULL_CHI2_CHUNK_BYTES",
                        p.L * p.Y * p.X * 4 - 1)
    got = tsm.full_chi2(p, st)
    assert calls == [256]
    _close(got, mono, 5e-6)
    # the rebaseline goes through full_chi2, every chain of a batch
    states = ch.init_chain_states(p, 2)
    tsm.rebaseline_chi2(p, states)
    assert calls == [256, 256, 256]


# ---------------------------------------------------------------------------
# lambda_chunk=None
# ---------------------------------------------------------------------------

def _jax_rule(L, Yc, Xc, dtype):
    """The JAX ``make_problem``'s ``lambda_chunk=None`` lines
    (``deconv3d_tpu/sampler.py:689-694``), executed as they stand on a
    geometry, without a cube of that size."""
    src = textwrap.dedent(inspect.getsource(jsm.make_problem))
    lines = src.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "if config.lambda_chunk is None:" in ln)
    end = next(i for i in range(start, len(lines))
               if "lambda_chunk=lam_chunk" in lines[i])
    block = textwrap.dedent("\n".join(lines[start:end + 1]))
    shim = types.SimpleNamespace(replace=lambda c, **kw: types.SimpleNamespace(
        **{**vars(c), **kw}))
    ns = {"config": types.SimpleNamespace(lambda_chunk=None), "L": L,
          "Yc": Yc, "Xc": Xc, "dtype": dtype, "np": np, "dataclasses": shim}
    exec(block, ns)
    return ns["config"].lambda_chunk


@pytest.mark.parametrize("L, Yc, Xc, dtype", [
    (3681, 306, 306, np.float32),      # the full MUSE field: 1.38 GB
    (3681, 306, 306, np.float64),
    (600, 102, 102, np.float32),       # 25 MB: off
    (2**26, 1, 1, np.float32),         # exactly 2**28 B: off
    (2**26 + 1, 1, 1, np.float32),     # one plane over: on
    (1, 2**14, 2**14, np.float64),     # one plane over the cap alone
])
def test_auto_lambda_chunk_is_the_jax_rule(L, Yc, Xc, dtype):
    want = _jax_rule(L, Yc, Xc, dtype)
    assert tsm.auto_lambda_chunk(L, Yc, Xc, np.dtype(dtype).itemsize) == want
    assert (want == 0) == (L * Yc * Xc * np.dtype(dtype).itemsize <= 2**28)


def test_lambda_chunk_resolves_as_in_jax():
    """``None`` resolves to the JAX ``make_problem``'s value on the same
    cube (0 at this size) and is recorded in ``problem.config``; an int is
    kept; above a lowered cap the port's rule turns chunking on."""
    data, noise = _data()
    var = np.full_like(data, noise**2)
    jcfg = jsm.RunConfig(fsf_size=5, lsf_width=5, dtype=np.float64)
    jp = jsm.make_problem(JCube.from_data(data, variance=var, crval=4750.0,
                                          cdelt=1.25, dtype=np.float64),
                          jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                                          lsf=jins.GaussianLSF(fwhm=2.0),
                                          pixel_scale=0.2), jcfg)
    assert _problem(lambda_chunk=None).config.lambda_chunk \
        == jp.config.lambda_chunk == 0
    assert _problem(lambda_chunk=4).config.lambda_chunk == 4
    p = _problem(lambda_chunk=None)
    slab = p.L * p.Yc * p.Xc * 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsm, "LAMBDA_CHUNK_AUTO_BYTES", slab // 4)
        got = _problem(lambda_chunk=None).config.lambda_chunk
    assert got == int((slab // 4) / (p.Yc * p.Xc * 8)) == 4


# ---------------------------------------------------------------------------
# The plain sweeps, chunked against unchunked
# ---------------------------------------------------------------------------

#: (sampler, engine, tile, positivity, bit-equal at every chunking)
SWEEPS = {
    "mh": ("mh", "torch", None, False, True),
    "mh_positivity": ("mh", "torch", None, True, True),
    "gibbs": ("gibbs", "torch", None, False, True),
    "gibbs_positivity": ("gibbs", "torch", None, True, True),
    "gibbs_block": ("gibbs_block", "torch", None, False, True),
    "mh_tiled": ("mh", "torch_tiled", (1, 1), False, False),
    "gibbs_tiled": ("gibbs", "torch_tiled", (2, 1), False, False),
}


def _assert_chunked_equal(got, want, bit_equal, what):
    for name in got:
        g, w = got[name], want[name]
        if bit_equal:
            assert torch.equal(g, w), f"{what}: {name}"
        else:
            # the float32 bookkeeping (χ², flux) rounds the float64 cubes'
            # last-bit differences, or sums the shards in another order
            rtol = 1e-6 if g.dtype == torch.float32 else 1e-12
            err = float((g.double() - w.double()).abs().max())
            assert err <= rtol * max(float(w.double().abs().max()), 1.0), (
                f"{what}: {name} {err}")


def _flat(result):
    out = {f"state.{f.name}": getattr(result.state, f.name)
           for f in dataclasses.fields(result.state)}
    out.update(chi2_trace=result.chi2_trace, flux_trace=result.flux_trace,
               monitor_trace=result.monitor_trace)
    return out


@pytest.fixture(scope="module")
def unchunked():
    return {}


@pytest.mark.parametrize("lc", [1, 7, L])
@pytest.mark.parametrize("case", list(SWEEPS))
def test_chunked_sweeps_match_unchunked(case, lc, unchunked):
    """3 sweeps of 2 chains with ``lambda_chunk=lc`` against
    ``lambda_chunk=0``, on the same Philox draws: every decision equal
    (the accept trace, which for gibbs counts the voxels drawn), the
    state and traces bit-equal or within 1e-12 (module docstring)."""
    sampler, engine, tile, pos, bit_equal = SWEEPS[case]

    def run(chunk):
        p = _problem(sampler, chunk, engine=engine, tile=tile,
                     positivity=pos)
        assert p.config.lambda_chunk == chunk
        return tsm.run_sweeps(p, ch.init_chain_states(p, 2), 3)

    if case not in unchunked:
        unchunked[case] = run(0)
    want, got = unchunked[case], run(lc)
    assert torch.equal(got.accept_trace, want.accept_trace)
    assert float(want.state.n_accept.sum()) > 0
    _assert_chunked_equal(_flat(got), _flat(want), bit_equal or lc == L,
                          f"{case} lc={lc}")


@pytest.mark.parametrize("lc", [1, 7, L])
@pytest.mark.parametrize("sampler", ["mh", "gibbs", "gibbs_block"])
def test_chunked_sharded_sweep_matches_unchunked(sampler, lc, unchunked):
    """The plain color step on 2 shards (``run_sweeps_sharded``), whose
    halo push sends the delta of each shard's first and last block rows:
    chunked == unchunked as above, and unchunked == the single-device
    sweep bit for bit (but the flux trace, a float32 sum of the shards'
    sums)."""
    mesh = Mesh(["cpu"] * 2, ("sp",))
    key = f"sharded_{sampler}"
    if key not in unchunked:
        p0 = _problem(sampler, 0)
        unchunked[key] = ss.run_sweeps_sharded(p0, tsm.init_state(p0), 3,
                                               mesh)
        one = tsm.run_sweeps(p0, tsm.init_state(p0), 3)
        got, want = _flat(unchunked[key]), _flat(one)
        del got["flux_trace"], want["flux_trace"]
        _assert_chunked_equal(got, want, True, f"{sampler} 2 shards")
    p = _problem(sampler, lc)
    got = ss.run_sweeps_sharded(p, tsm.init_state(p), 3, mesh)
    want = unchunked[key]
    assert torch.equal(got.accept_trace, want.accept_trace)
    _assert_chunked_equal(_flat(got), _flat(want), sampler == "mh" or lc == L,
                          f"{sampler} 2 shards lc={lc}")
