"""The tiled kernel K2's any-rank build (``tiled_<sampler>_kernel<8,
false>`` of ``csrc/tiled_sweep.cu``, the instantiation every chromatic
full-field reduction launches) against its plain version,
``ops/tiled.py::tiled_segment_reference``, on a cube with what a pipeline
exposure carries: an FSF whose FWHM falls with λ (rank S > 1), a NaN
border on every plane, a NaN column on the first tenth of the planes (swept
spaxels with NaN voxels), a masked block and a sky-line variance with an
exposure factor per spaxel; in (9, 9)-block tiles, four per sweep as on
the field.  The tracer counts an any-rank launch a sweep and no
rank-1 one.

Marked ``gpu``: the kernel has no CPU mode.  The file imports no JAX, so it
runs on a card machine that has none."""

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import metrics
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import sweep as sw
from deconv3d_tpu_torch.ops import tiled as tl

N_SWEEPS = 2
N_CHAINS = 2


def _exposure(L: int, size: int):
    """A ``[L, size, size]`` float32 cube over 4750-9350 Å and the field
    configuration's Moffat instrument (FWHM 0.66″ − 3e-5″/Å·(λ − 4750 Å)
    at 0.2″): noise whose variance carries the [O I] 5577 and 6300 Å sky
    lines and a factor per spaxel, two point sources, NaN rows and columns
    0 and size − 1 on every plane, column size − 2 NaN on planes 0 … L/10,
    and a masked block of 3 × 4 spaxels."""
    rng = np.random.default_rng(26)
    cdelt = 4600.0 / L
    lam = 4750.0 + cdelt * np.arange(L)
    sky = 1.0 + sum(a * np.exp(-0.5 * ((lam - c) / (1.5 * cdelt)) ** 2)
                    for c, a in ((5577.3, 30.0), (6300.3, 15.0)))
    var = sky[:, None, None] * rng.uniform(0.8, 1.25, (1, size, size))
    data = rng.standard_normal((L, size, size)) * np.sqrt(var)
    data[L // 2, size // 2, size // 3] += 50.0
    data[L // 3, size // 4, 2 * size // 3] += 30.0
    for where in ((slice(None), 0), (slice(None), -1),
                  (slice(None), slice(None), 0),
                  (slice(None), slice(None), -1),
                  (slice(0, max(1, L // 10)), slice(None), -2)):
        data[where] = var[where] = np.nan
    mask = np.zeros((size, size), dtype=bool)
    mask[size // 2:size // 2 + 3, size // 5:size // 5 + 4] = True
    cube = d3.Cube.from_data(data.astype(np.float32),
                             variance=var.astype(np.float32), mask=mask,
                             crval=4750.0, cdelt=cdelt, device="cuda")
    inst = ins.MUSE(fsf=ins.MoffatFSF(fwhm=0.66, beta=2.6, fwhm_slope=-3e-5,
                                      lambda_ref=4750.0))
    return cube, inst


@pytest.fixture
def _tracer_off():
    metrics.tracing(False)
    metrics.reset()
    yield
    metrics.tracing(False)
    metrics.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("sampler", ["gibbs", "mh"])
@pytest.mark.parametrize("f, size, L", [
    (17, 300, 16),   # the field's footprint and spaxels: 2 × 2 tiles
    (5, 88, 40),     # 2 × 2 tiles, the last block row and column ragged
])
def test_anyrank_tiled_kernel_matches_plain_on_chromatic_masked_cube(
        _tracer_off, sampler, f, size, L):
    """Same injected uniforms on both sides, 2 chains, 2 sweeps; the
    tolerances of the rank-1 K2 test (``tests/test_torch_run.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiled kernel has no CPU mode")
    cube, inst = _exposure(L, size)
    p = sm.make_problem(cube, inst, sm.RunConfig(
        sampler=sampler, dtype=np.float32, seed=4, fsf_size=f, lsf_width=11,
        tile=(9, 9)))
    assert p.config.engine == "cuda_tiled" and p.f == f
    assert int(p.fsf_spec.shape[0]) > 1, "a rank-1 FSF takes the <1> build"
    assert p.n_valid < size * size
    states = ch.init_chain_states(p, N_CHAINS)
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(9).random(
        (N_SWEEPS, N_CHAINS, p.n_colors, p.ny * p.nx, *per), dtype=np.float32)
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24)).cuda()
    if sampler == "mh":
        u, plain = sw.untie_uniforms(p, states, N_SWEEPS, u,
                                     reference=tl.tiled_segment_reference)
    else:
        plain = tl.tiled_segment_reference(p, states, N_SWEEPS, u)
    metrics.tracing(True)
    kern = tl.tiled_segment(p, states, N_SWEEPS, u)
    torch.cuda.synchronize()
    launches = {k: v for k, v in metrics.counters().items()
                if k.startswith("sweep.launches.rank")}
    assert launches == {"sweep.launches.rank_any": N_SWEEPS}
    assert float(plain.accept.sum()) > 0, "nothing drawn; test is vacuous"
    assert torch.equal(plain.accept, kern.accept)
    for name in ("resid", "clean"):
        ref = getattr(plain.result.state, name)
        torch.testing.assert_close(getattr(kern.result.state, name), ref,
                                   rtol=0, atol=1e-4 * float(ref.abs().max()))
    torch.testing.assert_close(kern.result.state.chi2,
                               plain.result.state.chi2, rtol=1e-5, atol=0)
