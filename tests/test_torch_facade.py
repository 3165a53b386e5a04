"""The port's ``Run`` facade beyond ``run`` / ``save``, on the CPU.

Mirrors of the JAX package's facade tests: the coarse-pass auto rule and
the blur warning (``tests/test_blur_default_flow.py``), the under-mixing
warning, ``run_until`` and its convergence window
(``tests/test_run_api.py``), ``resume``, and the SIGKILL fault injection
(``tests/test_fault_injection.py``) with a child that imports only the
port.  Checkpoints hold every chain's Philox key and absolute sweep, so a
resumed run — coarse passes included — is bit-equal to an uninterrupted
one.
"""

import json
import logging
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import instruments as ins

LOGGER = "deconv3d_tpu_torch"


def _toy(rng, L=16, Y=6, X=6, noise=0.2, fsf_fwhm=0.5, lsf_fwhm=2.0):
    """Synthetic emission-line cube + instrument (as tests/test_sampler.py),
    float64."""
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 1, 1] = 3.0
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=fsf_fwhm),
                          lsf=ins.GaussianLSF(fwhm=lsf_fwhm), pixel_scale=0.2)
    cube0 = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25,
                              dtype=np.float64)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=5, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=np.float64)
    return cube, inst


_KW = dict(fsf_size=5, lsf_width=5, dtype=np.float64, device="cpu")


def _blurred_case(rng, L=24, Y=16, X=16, amp=100.0, noise=0.05,
                  fsf_fwhm=0.5, fsf_size=9):
    """Heavy blur relative to the field: f=9 on a 16×16 field (f ≥ Y/2)."""
    truth = np.zeros((L, Y, X), np.float32)
    truth[L // 2, Y // 2, X // 2] = amp
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=fsf_fwhm),
                          lsf=ins.GaussianLSF(fwhm=1.5), pixel_scale=0.2)
    cube0 = d3.Cube.from_data(truth, crval=4750.0, cdelt=1.25)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=fsf_size, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape).astype(np.float32)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25)
    return cube, inst


def _large_case(rng, L=4, Y=104, X=104):
    """A field above COARSE_AUTO_MIN_SPAXELS with a footprint of 9."""
    truth = np.zeros((L, Y, X), np.float32)
    truth[L // 2, Y // 2, X // 2] = 50.0
    data = truth + 0.1 * rng.standard_normal(truth.shape).astype(np.float32)
    cube = d3.Cube.from_data(data, variance=np.full_like(data, 0.01),
                             crval=4750.0, cdelt=1.25)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=1.5), pixel_scale=0.2)
    return cube, inst


# ---------------------------------------------------------------------------
# The coarse-pass auto rule and the blur warning
# ---------------------------------------------------------------------------

def test_auto_coarse_fires_on_large_blurred_field_mh(rng, caplog):
    cube, inst = _large_case(rng)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        run = d3.Run(cube, inst, max_iterations=10, fsf_size=9,
                     lsf_width=5, device="cpu")
    assert run.config.coarse_every == 8
    assert run.config.coarse_mode == "global"
    assert run.problem.config == run.config
    assert any("enabling global coarse-pattern passes" in r.message
               for r in caplog.records)


@pytest.mark.parametrize("kw", [dict(sampler="gibbs"), dict(coarse_every=0),
                                dict(fsf_size=5)])
def test_auto_coarse_stays_off_on_large_field(rng, kw):
    """gibbs is excluded (a box-flux ESS/s loss in the JAX package's
    measurement), ``coarse_every=0`` opts out, a footprint below 9 has no
    blur-null modes to attack."""
    cube, inst = _large_case(rng)
    run = d3.Run(cube, inst, max_iterations=10, lsf_width=5, device="cpu",
                 **{"fsf_size": 9, **kw})
    assert run.config.coarse_every is None
    assert run.problem.config.coarse_every is None


def test_auto_coarse_stays_off_on_blur_dominated_small_field(rng, caplog):
    """A small blur-dominated field warns instead (the passes measured a
    wall-clock loss there in the JAX package)."""
    cube, inst = _blurred_case(rng)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        run = d3.Run(cube, inst, max_iterations=10, fsf_size=9, lsf_width=5,
                     device="cpu")
    assert not run.config.coarse_every
    assert any("NOT auto-enabled" in r.message and "coarse_every=8"
               in r.message for r in caplog.records), \
        [r.message for r in caplog.records]


def test_no_blur_warning_when_blur_is_small_or_coarse_is_set(rng, caplog):
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        cube, inst = _blurred_case(rng, Y=24, X=24, fsf_size=5,
                                   fsf_fwhm=0.25)
        run = d3.Run(cube, inst, max_iterations=10, fsf_size=5, lsf_width=5,
                     device="cpu")
        assert not run.config.coarse_every
        cube, inst = _blurred_case(rng)
        run = d3.Run(cube, inst, max_iterations=10, fsf_size=9, lsf_width=5,
                     coarse_every=16, device="cpu")
        assert run.config.coarse_every == 16
    assert not [r for r in caplog.records if "NOT auto-enabled" in r.message]


def test_undermixed_warning_fires_without_coarse(rng, caplog):
    """The blur-dominated default flow (plain mh) tells the user why the
    posterior mean will look like noise, and names the coarse passes."""
    cube, inst = _blurred_case(rng)
    run = d3.Run(cube, inst, max_iterations=130, burn_in=20, sampler="mh",
                 fsf_size=9, lsf_width=5, seed=3, device="cpu")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        run.run()
    assert any("monitor-voxel ESS" in r.message and "coarse_every"
               in r.message for r in caplog.records), \
        [r.message for r in caplog.records]


def test_no_undermixed_warning_on_a_short_window(rng, caplog):
    """Fewer than 100 post-burn-in sweeps: no ESS estimate, no warning."""
    cube, inst = _blurred_case(rng)
    run = d3.Run(cube, inst, max_iterations=60, burn_in=20, sampler="mh",
                 fsf_size=9, lsf_width=5, seed=3, device="cpu")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        run.run()
    assert not [r for r in caplog.records
                if "monitor-voxel ESS" in r.message]


# ---------------------------------------------------------------------------
# run_until and its convergence window
# ---------------------------------------------------------------------------

def test_run_until_rhat_converges(rng):
    """run_until stops once the R̂ and ESS targets hold."""
    cube, inst = _toy(rng, L=8, fsf_fwhm=0.25, lsf_fwhm=1.0)
    run = d3.Run(cube, inst, max_iterations=2000, burn_in=30, seed=2,
                 n_chains=4, sampler="gibbs", **_KW)
    d = run.run_until(rhat=1.2, min_ess=20, check_every=50)
    assert d["converged"]
    assert d["rhat_max"] <= 1.2
    assert d["ess_chi2"] >= 20
    assert run.sweeps_done == d["sweeps"] < 2000


def test_run_until_caps_at_max_sweeps(rng, caplog):
    cube, inst = _toy(rng)
    run = d3.Run(cube, inst, max_iterations=10_000, burn_in=10, seed=7,
                 n_chains=2, **_KW)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        d = run.run_until(min_ess=1e9, rhat=None, check_every=20,
                          max_sweeps=60)
    assert not d["converged"]
    assert run.sweeps_done == 60
    assert any("max_sweeps=60" in r.message for r in caplog.records)


def test_run_until_single_chain_needs_ess(rng):
    cube, inst = _toy(rng)
    run = d3.Run(cube, inst, max_iterations=100, burn_in=10, seed=1, **_KW)
    with pytest.raises(ValueError):
        run.run_until()  # single chain, no min_ess
    with pytest.raises(ValueError):
        d3.Run(cube, inst, n_chains=2, **_KW).run_until(rhat=None)
    d = run.run_until(min_ess=5, check_every=30, max_sweeps=600)
    assert "rhat_max" not in d
    assert d["converged"] or run.sweeps_done == 600


def test_run_until_undersized_window_not_converged(rng):
    """A window too short for split-R̂ (< 2 samples per half) reads as NOT
    converged, never as the ideal 1.0."""
    cube, inst = _toy(rng)
    run = d3.Run(cube, inst, max_iterations=1000, burn_in=500, seed=5,
                 n_chains=2, **_KW)
    d = run.run_until(rhat=1.01, check_every=20, max_sweeps=40)
    assert not d["converged"]
    assert d["rhat_max"] == float("inf")
    assert d["rhat_monitor_max"] == float("inf")


def test_convergence_window_rebases_after_resume(tmp_path, rng):
    """burn_in counts absolute sweeps; after a resume the process-local
    trace is shorter than sweeps_done, so the window is rebased to trace
    coordinates."""
    cube, inst = _toy(rng)
    kw = dict(max_iterations=200, burn_in=40, seed=9, n_chains=2, **_KW)
    path = str(tmp_path / "ck.npz")
    d3.Run(cube, inst, checkpoint_path=path, **kw).run(50)
    second = d3.Run(cube, inst, checkpoint_path=path, **kw).resume()
    assert second.sweeps_done == 50
    second.run(30)                      # local trace n=30, sweeps_done=80
    d = second._convergence_criteria(40)
    assert d["window"] == [15, 30]
    assert np.isfinite(d["rhat_max"])


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coarse_every", [0, 4])
def test_resume_is_bit_exact(tmp_path, rng, coarse_every):
    """12 sweeps, a checkpoint after 7, resumed by a new ``Run`` for the
    last 5: every state field equal to one uninterrupted run, coarse
    passes (after absolute sweeps 4, 8, 12) included."""
    cube, inst = _toy(rng, Y=10, X=10)
    kw = dict(max_iterations=12, burn_in=4, seed=4, n_chains=2,
              coarse_every=coarse_every, **_KW)
    path = str(tmp_path / "ck")
    d3.Run(cube, inst, checkpoint_path=path, **kw).run(7)
    resumed = d3.Run(cube, inst, **kw).resume(path)
    assert resumed.sweeps_done == 7
    resumed.run(5)
    whole = d3.Run(cube, inst, **kw).run()
    for name in ("clean", "resid", "key", "sweep", "chi2", "log_scale",
                 "sum_clean", "sum_sq", "n_accept", "n_propose"):
        assert torch.equal(getattr(resumed.states, name),
                           getattr(whole.states, name)), name
    np.testing.assert_array_equal(resumed.trace("chi2"),
                                  whole.trace("chi2")[:, 7:])
    if coarse_every:
        fine = 12 * whole.problem.n_valid
        assert float(whole.states.n_propose[0]) > fine
    with pytest.raises(ValueError, match="checkpoint"):
        d3.Run(cube, inst, **kw).resume()


TOTAL = 24
SEG = 4

CHILD = textwrap.dedent(
    """
    import sys, time
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {testdir!r})
    import numpy as np
    import deconv3d_tpu_torch as d3
    from test_torch_facade import _KW, _toy

    cube, inst = _toy(np.random.default_rng(42), Y=10, X=10)
    run = d3.Run(cube, inst, max_iterations={total}, burn_in=8, seed=5,
                 segment_size={seg}, checkpoint_path={ckpt!r},
                 coarse_every=4, **_KW)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                          "deconv3d_tpu")]
    assert not bad, bad
    print("READY", flush=True)
    # one segment at a time, with a pause after each checkpoint, so the
    # parent has a window to SIGKILL the process mid-run
    while run.sweeps_done < {total}:
        run.run(n_sweeps={seg})
        time.sleep(0.5)
    print("FINISHED", flush=True)   # never printed: the parent kills us
    """
)


def test_sigkill_mid_run_resumes_bit_exact(tmp_path):
    """A child process that imports only the port runs with a checkpoint
    path and coarse passes every 4 sweeps; SIGKILL it mid-run (no cleanup
    of any kind), resume from its last checkpoint, finish, and hold the
    result bit-equal to an uninterrupted run."""
    ckpt = str(tmp_path / "fault_ck.npz")
    testdir = os.path.dirname(os.path.abspath(__file__))
    child = CHILD.format(root=os.path.dirname(testdir), testdir=testdir,
                         total=TOTAL, seg=SEG, ckpt=ckpt)
    proc = subprocess.Popen([sys.executable, "-c", child], cwd=testdir,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    deadline = time.time() + 300
    killed_at = None
    try:
        while time.time() < deadline:
            if proc.poll() is not None:
                _, err = proc.communicate()
                pytest.fail(f"child finished before it could be killed:\n{err}")
            if os.path.exists(ckpt):
                try:
                    with np.load(ckpt) as z:
                        done = json.loads(str(z["meta"])).get("sweeps_done", 0)
                except Exception:
                    done = 0  # torn read; try again
                if 0 < done < TOTAL:
                    os.kill(proc.pid, signal.SIGKILL)
                    proc.wait(timeout=60)
                    killed_at = done
                    break
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert killed_at is not None, "never observed a mid-run checkpoint"

    cube, inst = _toy(np.random.default_rng(42), Y=10, X=10)
    kw = dict(max_iterations=TOTAL, burn_in=8, seed=5, segment_size=SEG,
              coarse_every=4, **_KW)
    resumed = d3.Run(cube, inst, **kw).resume(ckpt)
    # the child may have written one more checkpoint between the read and
    # the kill landing: any mid-run checkpoint at or past it is a kill point
    assert killed_at <= resumed.sweeps_done < TOTAL
    resumed.run(n_sweeps=TOTAL - resumed.sweeps_done)
    reference = d3.Run(cube, inst, **kw).run()
    for name in ("clean", "chi2", "key", "sum_clean", "n_propose"):
        assert torch.equal(getattr(resumed.states, name),
                           getattr(reference.states, name)), name
