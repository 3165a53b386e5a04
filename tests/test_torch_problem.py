"""The torch port's kernel-engine problem and initial state against JAX.

The port's ``make_problem`` builds what the JAX package builds for its
kernel engines (``engine='pallas'``, which also builds on the CPU):
bfloat16-valued weights and the low-rank FSF reconstruction.  Tolerances:
exact where both sides round the same float32 values (weights, masks,
monitor indices, the NumPy FSF factorisation), rtol 1e-5 where float32 sums
run in another order (quad, chi², residual).
"""

import numpy as np
import pytest
import torch

import jax

from deconv3d_tpu import Cube as JCube
from deconv3d_tpu import instruments as jins
from deconv3d_tpu import sampler as jsm
from deconv3d_tpu_torch import Cube as TCube
from deconv3d_tpu_torch import instruments as tins
from deconv3d_tpu_torch import sampler as tsm


@pytest.fixture(autouse=True)
def _f32_mode():
    """The kernel engine is float32-only; build the JAX side without x64."""
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _inputs(rng, L=16, Y=6, X=7):
    truth = np.zeros((L, Y, X), np.float32)
    truth[8, 3, 3] = 5.0
    data = truth + 0.1 * rng.standard_normal((L, Y, X)).astype(np.float32)
    var = np.full_like(data, 0.01) * (1.0 + rng.random(data.shape)).astype(
        np.float32)
    var[3, 1, 2] = 0.0                      # invalid variance → zero weight
    mask = np.zeros((Y, X), bool)
    mask[2, 5] = True
    return data, var, mask


def _both(rng, **cfg_kw):
    data, var, mask = _inputs(rng)
    kw = dict(max_iterations=6, burn_in=2, seed=1, fsf_size=5, lsf_width=5,
              **cfg_kw)
    jp = jsm.make_problem(
        JCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                        cdelt=1.25),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                        lsf=jins.GaussianLSF(fwhm=2.0)),
        jsm.RunConfig(engine="pallas", **kw),
    )
    tp = tsm.make_problem(
        TCube.from_data(data, variance=var, mask=mask, crval=4750.0,
                        cdelt=1.25),
        tins.Instrument(fsf=tins.GaussianFSF(fwhm=0.5),
                        lsf=tins.GaussianLSF(fwhm=2.0)),
        tsm.RunConfig(**kw),
    )
    return jp, tp


def test_make_problem_matches_kernel_engine(rng):
    jp, tp = _both(rng)
    assert tp.config.engine == "torch"
    for name in ("L", "Y", "X", "f", "ny", "nx", "Hp", "Wp", "Yc", "Xc"):
        assert getattr(tp, name) == getattr(jp, name), name
    # bf16-rounded weights and data: the same float32 values
    np.testing.assert_array_equal(tp.w_pad.numpy(), np.asarray(jp.w_pad))
    w = tp.w_pad.numpy()
    assert np.array_equal(
        w, w.astype(np.float32).view(np.uint32).__and__(0xFFFF0000)
        .view(np.float32)
    ), "weights are not bfloat16 values"
    np.testing.assert_array_equal(tp.data_pad.numpy(), np.asarray(jp.data_pad))
    # factored FSF (NumPy SVD on both sides)
    for name in ("fsf", "fsf_spec", "fsf_imgs", "lsf"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), name
        )
    np.testing.assert_allclose(tp.quad.numpy(), np.asarray(jp.quad),
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_array_equal(tp.monitor_idx.numpy(),
                                  np.asarray(jp.monitor_idx))
    assert not tp.valid.numpy()[2, 5], "masked spaxel must be invalid"


def test_init_state_matches(rng):
    jp, tp = _both(rng)
    js, ts = jsm.init_state(jp), tsm.init_state(tp)
    np.testing.assert_allclose(float(ts.chi2), float(js.chi2), rtol=1e-5)
    r = np.asarray(js.resid)
    np.testing.assert_allclose(ts.resid.numpy(), r, rtol=0,
                               atol=1e-5 * np.abs(r).max())
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               rtol=1e-5, atol=1e-6)
    assert int(ts.key) == 1 and int(ts.sweep) == 0


def test_init_state_jump_scale_and_data_start(rng):
    jp, tp = _both(rng, jump_scale=0.3, initial="data")
    js, ts = jsm.init_state(jp), tsm.init_state(tp)
    np.testing.assert_allclose(ts.log_scale.numpy(), np.asarray(js.log_scale),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.clean.numpy(), np.asarray(js.clean))
    np.testing.assert_allclose(float(ts.chi2), float(js.chi2), rtol=1e-5)


def test_full_chi2_matches(rng):
    jp, tp = _both(rng)
    clean = rng.standard_normal((jp.L, jp.Yc, jp.Xc)).astype(np.float32)
    js = jsm.init_state(jp)
    ts = tsm.init_state(tp)
    js.clean = jax.numpy.asarray(clean)
    ts.clean = torch.as_tensor(clean)
    np.testing.assert_allclose(float(tsm.full_chi2(tp, ts)),
                               float(jsm.full_chi2(jp, js)), rtol=1e-5)


def test_adapt_and_keep_schedules_match():
    cfg_kw = dict(max_iterations=40, burn_in=10, keep_one_in=3)
    ids = np.arange(0, 40)
    for decay in (0.7, None):
        jc = jsm.RunConfig(adapt_decay=decay, **cfg_kw)
        tc = tsm.RunConfig(adapt_decay=decay, **cfg_kw)
        np.testing.assert_array_equal(
            tsm.adapt_schedule(torch.as_tensor(ids), tc).numpy(),
            np.asarray(jsm.adapt_schedule(jax.numpy.asarray(ids, "int32"), jc)),
        )
    keep = tsm.keep_schedule(torch.as_tensor(ids), tc).numpy()
    assert keep.tolist() == [
        float(i >= 10 and (i - 10) % 3 == 0) for i in ids
    ]


@pytest.mark.parametrize(
    "knob, value",
    [
        ("lambda_chunk", 4),
    ],
)
def test_unported_knobs_raise(rng, knob, value):
    """The knobs that raised ``NotImplementedError`` until they were
    ported: none raises now, and the value reaches ``problem.config``
    (``lambda_chunk``: ``tests/test_torch_chunk.py``)."""
    data, var, mask = _inputs(rng)
    cube = TCube.from_data(data, variance=var, crval=4750.0, cdelt=1.25)
    p = tsm.make_problem(cube, tins.MUSE(), tsm.RunConfig(**{knob: value}),
                         device="cpu")
    assert getattr(p.config, knob) == value
