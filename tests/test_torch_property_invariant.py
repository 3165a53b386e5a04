"""Property-based test of the residual invariant on the port's plain engines.

The counterpart of ``tests/test_property_invariant.py``: over random
geometries, FSF sizes, LSF widths, masks and seeds, the incrementally
maintained residual must equal data − conv(clean) after 12 sweeps, and the
running χ² the from-scratch one.  Besides the JAX test's space it covers
every MCMC sampler of the port (``mh``, ``gibbs``, ``gibbs_block``), the
positivity flag (clean ≥ 0 then holds too) and both plain engines (the
whole-cube scan and the tiled scan in (1, 1) tiles).  Each (sampler,
positivity, engine) combination is a case of its own, so every one is
searched on every run.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These toys are a few hundred voxels: torch's intra-op threads cost
    more than they give, and under a parallel test run they contend with
    the other workers' (module scope: hypothesis re-runs a test body
    without re-entering function-scoped fixtures)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (sampler, positivity, engine): gibbs_block runs on the whole-cube engine
#: only and has no positivity (both refused by ``make_problem``)
COMBOS = [(s, pos, e) for s in ("mh", "gibbs") for pos in (False, True)
          for e in ("torch", "torch_tiled")] + [("gibbs_block", False,
                                                 "torch")]


def _invariant_case(seed, L, Y, X, fsf_size, lsf_width, fwhm, mask_one,
                    sampler, positivity, engine):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(L, Y, X))
    mask = None
    if mask_one:
        mask = np.zeros((Y, X), dtype=bool)
        mask[rng.integers(Y), rng.integers(X)] = True
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.25),
                             mask=mask, crval=4750.0, cdelt=1.25,
                             dtype=np.float64)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=fwhm),
                          lsf=ins.GaussianLSF(fwhm=1.5))
    cfg = sm.RunConfig(
        max_iterations=12, burn_in=4, seed=seed, dtype=np.float64,
        fsf_size=fsf_size, lsf_width=lsf_width, sampler=sampler,
        positivity=positivity, engine=engine,
        tile=(1, 1) if engine == "torch_tiled" else None)
    p = sm.make_problem(cube, inst, cfg, device="cpu")
    assert p.config.engine == engine
    st_ = sm.run_sweeps(p, sm.init_state(p), 12).state

    h = p.f // 2
    conv = cv.convolve_cube(st_.clean[:, : p.Y, : p.X], p.fsf, p.lsf)
    model = (p.data_pad - st_.resid)[:, h : h + p.Y, h : h + p.X]
    w = p.w_pad[:, h : h + p.Y, h : h + p.X].numpy()
    np.testing.assert_allclose(model.numpy()[w > 0], conv.numpy()[w > 0],
                               atol=1e-9)
    # χ² is tracked in float32 (Kahan-compensated); a fresh float32
    # reduction has its own ~1e-6-relative accumulation error
    np.testing.assert_allclose(float(st_.chi2), float(sm.full_chi2(p, st_)),
                               rtol=1e-5, atol=1e-5)
    clean = st_.clean.numpy()[:, : p.Y, : p.X]
    if mask is not None:
        assert (clean[:, mask] == 0).all()
    if positivity:
        assert clean.min() >= 0.0


@pytest.mark.parametrize("sampler,positivity,engine", COMBOS)
@settings(max_examples=10, deadline=None, derandomize=True)
@given(
    seed=st.integers(0, 2**16),
    L=st.sampled_from([9]),
    Y=st.sampled_from([5, 6]),
    X=st.sampled_from([5]),
    fsf_size=st.sampled_from([3, 5]),
    lsf_width=st.sampled_from([1, 3]),
    fwhm=st.floats(0.1, 0.8),
    mask_one=st.booleans(),
)
def test_incremental_invariant_property(sampler, positivity, engine, seed, L,
                                        Y, X, fsf_size, lsf_width, fwhm,
                                        mask_one):
    _invariant_case(seed, L, Y, X, fsf_size, lsf_width, fwhm, mask_one,
                    sampler, positivity, engine)
