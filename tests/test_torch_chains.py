"""Chain batching in the torch port: one batched segment for all chains.

The kernels take a leading chain axis on every per-chain array (residual,
clean cube, log-scales, Philox key) and share everything else; chains in a
batch advance in lockstep.  On the CPU the plain versions batch the same
way, so these tests hold a batch of chains against the same chains run one
at a time (float64, where a summation order cannot flip an MH decision:
decisions identical, states within 1e-6 relative — batched and unbatched
einsums may round differently), and check how ``run_chains`` groups them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import convolve as cv
from deconv3d_tpu_torch import Cube
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.ops import sweep as sw

C = 3
N_SWEEPS = 4


def _problem(rng, sampler):
    L, Y, X, noise = 16, 6, 6, 0.1
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    cube0 = Cube.from_data(truth, crval=4750.0, cdelt=1.25, dtype=np.float64)
    fsf = inst.fsf.bank(cube0.wavelengths(), size=5, pixel_scale=0.2)
    lsf = inst.lsf.bank(cube0.wavelengths(), cdelt=1.25, width=5)
    conv = cv.convolve_cube(torch.as_tensor(truth), fsf, lsf).numpy()
    data = conv + noise * rng.standard_normal(conv.shape)
    mask = np.zeros((Y, X), bool)
    mask[0, 2] = True
    cube = Cube.from_data(data, variance=np.full_like(data, noise**2),
                          mask=mask, crval=4750.0, cdelt=1.25,
                          dtype=np.float64)
    cfg = sm.RunConfig(max_iterations=12, burn_in=2, seed=5, fsf_size=5,
                       lsf_width=5, dtype=np.float64, sampler=sampler)
    return sm.make_problem(cube, inst, cfg)


def _close(a, b, name):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_batch_equals_chains_run_alone(rng, sampler):
    p = _problem(rng, sampler)
    states = ch.init_chain_states(p, C)
    # chains at different points of their runs, as after a warm-up
    states = sm.run_sweeps(p, states, 2).state
    seg = sw.gibbs_segment if sampler == "gibbs" else sw.mh_segment
    batch = seg(p, states, N_SWEEPS)
    assert batch.accept.shape == (N_SWEEPS, C, p.n_colors, p.ny * p.nx)
    assert batch.result.chi2_trace.shape == (C, N_SWEEPS)
    for c in range(C):
        alone = seg(p, ch.select_chains(states, c), N_SWEEPS)
        # the same draws alone or in a batch: the same decisions
        assert torch.equal(alone.accept, batch.accept[:, c]), c
        mine = ch.select_chains(batch.result.state, c)
        for name in ("clean", "resid", "log_scale", "sum_clean", "sum_sq",
                     "chi2"):
            _close(getattr(mine, name), getattr(alone.result.state, name),
                   f"chain {c}: {name}")
        for name in ("n_accept", "n_propose", "n_kept", "sweep", "key"):
            assert torch.equal(getattr(mine, name),
                               getattr(alone.result.state, name)), name
        _close(batch.result.chi2_trace[c], alone.result.chi2_trace, "chi2 trace")
        _close(batch.result.flux_trace[c], alone.result.flux_trace, "flux")
        assert torch.equal(batch.result.accept_trace[c],
                           alone.result.accept_trace)
    assert float(batch.accept.sum()) > 0, "nothing accepted; test is vacuous"
    assert not torch.equal(batch.dchi[:, 0], batch.dchi[:, 1]), (
        "chains 0 and 1 drew the same numbers")


@pytest.mark.parametrize("sampler", ["mh", "gibbs"])
def test_batched_injected_uniforms(rng, sampler):
    """Injected uniforms carry a chain axis after the sweep axis."""
    p = _problem(rng, sampler)
    states = ch.init_chain_states(p, C)
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = rng.random((2, C, p.n_colors, p.ny * p.nx, *per))
    u = torch.as_tensor(np.clip(u, 2.0**-24, 1.0 - 2.0**-24))
    ref = (sw.gibbs_segment_reference if sampler == "gibbs"
           else sw.mh_segment_reference)
    batch = ref(p, states, 2, u)
    one = ref(p, ch.select_chains(states, 1), 2, u[:, 1])
    assert torch.equal(one.accept, batch.accept[:, 1])
    _close(batch.result.state.clean[1], one.result.state.clean, "clean")
    with pytest.raises(ValueError, match="uniforms must be"):
        ref(p, states, 2, u[:, :2])


def test_mismatched_sweep_counters_raise(rng):
    p = _problem(rng, "mh")
    states = ch.init_chain_states(p, C)
    states.sweep = torch.tensor([4, 4, 5])
    with pytest.raises(ValueError, match="lockstep"):
        sm.run_sweeps(p, states, 1)
    with pytest.raises(ValueError, match="lockstep"):
        sw.gibbs_segment_reference(_problem(rng, "gibbs"), states, 1)


def _counting(monkeypatch):
    calls = []
    real = sm.run_sweeps

    def run_sweeps(problem, state, n_sweeps):
        calls.append((state.clean.shape[0], n_sweeps))
        return real(problem, state, n_sweeps)

    monkeypatch.setattr(sm, "run_sweeps", run_sweeps)
    return calls


def test_run_chains_makes_one_batched_call(rng, monkeypatch):
    p = _problem(rng, "mh")
    calls = _counting(monkeypatch)
    mc = ch.run_chains(p, C, n_sweeps=3)
    assert calls == [(C, 3)]
    assert mc.n_chains == C and mc.result.chi2_trace.shape == (C, 3)
    assert ch.max_chain_batch(p, 32) == 32, "the CPU has no memory budget"


def test_memory_grouping_splits_the_batch(rng, monkeypatch):
    p = _problem(rng, "gibbs")
    whole = ch.run_chains(p, C, n_sweeps=3)
    per = ch.segment_bytes_per_chain(p)
    assert per > 4 * p.L * p.Hp * p.Wp
    monkeypatch.setattr(ch, "device_free_bytes", lambda device: 2 * per + 1)
    assert ch.max_chain_batch(p, C) == 2
    calls = _counting(monkeypatch)
    parts = ch.run_chains(p, C, n_sweeps=3)
    assert calls == [(2, 3), (1, 3)]
    for fld in dataclasses.fields(sm.SamplerState):
        _close(getattr(parts.result.state, fld.name).double(),
               getattr(whole.result.state, fld.name).double(), fld.name)
    assert parts.result.chi2_trace.shape == (C, 3)
    monkeypatch.setattr(ch, "device_free_bytes", lambda device: 1)
    assert ch.max_chain_batch(p, C) == 1


def test_run_n_chains_goes_through_the_batch(rng, monkeypatch):
    import deconv3d_tpu_torch as d3

    p = _problem(rng, "gibbs")
    calls = _counting(monkeypatch)
    cube = Cube.from_data(p.data_pad[:, 2:8, 2:8].float().numpy(),
                          variance=np.full((p.L, 6, 6), 0.01, np.float32),
                          crval=4750.0, cdelt=1.25)
    run = d3.Run(cube, ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                                      lsf=ins.GaussianLSF(fwhm=2.0)),
                 sampler="gibbs", n_chains=4, max_iterations=10, burn_in=4,
                 fsf_size=5, lsf_width=5, segment_size=5, device="cpu")
    run.run()
    assert calls == [(4, 5), (4, 5)]
    diag = run.diagnostics()
    assert diag["acceptance_rate"] == 1.0 and np.isfinite(diag["rhat_chi2"])
    assert run.trace("chi2").shape == (4, 10)
