"""Multi-chain layer and convergence diagnostics.

Counterpart of ``deconv3d_tpu/chains.py``.  All chains of a run go through
one batched segment per call (``sampler.run_sweeps`` on a chain-stacked
state: on a CUDA device one kernel launch per sweep for the whole batch);
they are split into groups only where the batch's working set would not fit
the card's free memory.  On a mesh (``parallel/mesh.py``) the chains split
over its slots, each slot's group one batch on its device; with a spatial
axis each chain also shards its sweep (``parallel/kernel_sharded.py``).
Convergence is quantified with split-R̂ (Gelman-Rubin) and effective
sample size from per-sweep traces (NumPy, unchanged from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import metrics
from . import sampler as sm


# ---------------------------------------------------------------------------
# Convergence diagnostics
# ---------------------------------------------------------------------------

def gelman_rubin(traces) -> float:
    """Split-R̂ over chain traces ``[n_chains, n_draws]`` (Gelman et al.).

    Each chain is split in half (guards against trending chains), then
    R̂ = sqrt(((n-1)/n·W + B/n) / W).  Values ≲ 1.01 indicate convergence.
    """
    x = np.asarray(traces, dtype=np.float64)
    if x.ndim != 2:
        raise ValueError("traces must be [n_chains, n_draws]")
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    x = x[:, : 2 * half].reshape(2 * m, half)
    within = x.var(axis=1, ddof=1).mean()
    between = half * x.mean(axis=1).var(ddof=1)
    if within == 0:
        return 1.0 if between == 0 else float("inf")
    var_plus = (half - 1) / half * within + between / half
    return float(np.sqrt(var_plus / within))


def effective_sample_size(traces) -> float:
    """Multi-chain ESS via FFT autocorrelation + Geyer initial monotone
    sequence (the standard estimator, cf. Stan/ArviZ)."""
    x = np.asarray(traces, dtype=np.float64)
    if x.ndim == 1:
        x = x[None]
    m, n = x.shape
    if n < 4:
        return float(m * n)
    x = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    acov /= np.arange(n, 0, -1)  # unbiased normalisation
    var = acov[:, 0].mean()
    if var == 0:
        return float(m * n)
    rho = acov.mean(axis=0) / var
    # Geyer: sum consecutive pairs while positive and monotone decreasing
    tau = 1.0
    prev = np.inf
    for t in range(1, n - 1, 2):
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        tau += 2.0 * pair
        prev = pair
    return float(m * n / max(tau, 1.0))


# ---------------------------------------------------------------------------
# Stacking chains
# ---------------------------------------------------------------------------

def _fieldwise(fn, items):
    """``fn`` of each field's values across ``items`` (dataclasses of
    tensors, nested ones recursed; a None item gives None values), as a
    dataclass of the same type."""
    first = next(it for it in items if it is not None)
    out = {}
    for fld in dataclasses.fields(first):
        vals = [None if it is None else getattr(it, fld.name) for it in items]
        out[fld.name] = (
            _fieldwise(fn, vals)
            if dataclasses.is_dataclass(getattr(first, fld.name))
            else fn(vals)
        )
    return type(first)(**out)


def gather_chains(groups, slots, device):
    """Chain-stacked dataclasses, one per slot of ``slots``
    (``parallel.mesh.Slots``; None where another rank holds it), joined
    along the chain axis on ``device`` on every rank of ``slots``."""
    from .parallel import mesh as pm

    return _fieldwise(lambda vals: pm.gather(vals, device, 0, slots.ranks),
                      groups)


def stack_chains(items):
    """Stack single-chain dataclasses along a new leading chain axis."""
    return _fieldwise(torch.stack, items)


def select_chains(batched, index):
    """Chains ``index`` (an int or a slice) of a chain-stacked dataclass."""
    return _fieldwise(lambda vals: vals[0][index], [batched])


@dataclasses.dataclass
class MultiChainResult:
    """Batched ChainResult: every tensor has leading axis n_chains."""

    result: sm.ChainResult

    @property
    def n_chains(self) -> int:
        return self.result.chi2_trace.shape[0]

    def diagnostics(self, discard_frac: float = 0.0) -> Dict[str, float]:
        """R̂ and ESS per monitored statistic, from post-burn-in traces."""
        out: Dict[str, float] = {}
        start = int(self.result.chi2_trace.shape[1] * discard_frac)
        for name, tr in (
            ("chi2", self.result.chi2_trace),
            ("flux", self.result.flux_trace),
        ):
            t = tr.cpu().numpy()[:, start:]
            out[f"rhat_{name}"] = gelman_rubin(t)
            out[f"ess_{name}"] = effective_sample_size(t)
        mon = self.result.monitor_trace.cpu().numpy()[:, start:, :]
        rhats = [gelman_rubin(mon[:, :, k]) for k in range(mon.shape[-1])]
        rhats = [r for r in rhats if np.isfinite(r)]
        if rhats:
            out["rhat_monitor_max"] = float(np.max(rhats))
            out["rhat_monitor_mean"] = float(np.mean(rhats))
        return out

    def posterior_mean(self, problem: sm.Problem) -> torch.Tensor:
        """Pooled posterior mean over all chains' kept samples."""
        s = self.result.state
        total = torch.sum(s.sum_clean, dim=0)
        n = torch.clamp(torch.sum(s.n_kept), min=1.0)
        return (total / n)[:, : problem.Y, : problem.X]

    def rhat_cube(self, problem: sm.Problem) -> np.ndarray:
        """Dense per-voxel Gelman-Rubin R̂ [L, Y, X] from the accumulators
        (not split-R̂: no within-chain halves are stored)."""
        s = self.result.state
        m = s.sum_clean.shape[0]
        if m < 2:
            raise ValueError("rhat_cube needs >= 2 chains")
        n = np.maximum(s.n_kept.cpu().numpy().astype(np.float64), 1.0)
        if np.any(n < 2):
            raise ValueError("rhat_cube needs >= 2 kept samples per chain")
        nn = n.reshape(m, 1, 1, 1)
        means = s.sum_clean.cpu().numpy().astype(np.float64) / nn
        within = (
            s.sum_sq.cpu().numpy().astype(np.float64) / nn - means**2
        ) * (nn / (nn - 1.0))
        W = within.mean(axis=0)
        navg = float(n.mean())
        B = navg * means.var(axis=0, ddof=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            var_plus = (navg - 1.0) / navg * W + B / navg
            rhat = np.sqrt(var_plus / W)
        rhat = np.where(W <= 0, np.where(B <= 0, 1.0, np.inf), rhat)
        return rhat[:, : problem.Y, : problem.X]


def chain_key(seed: int, chain: int) -> int:
    """64-bit Philox key of chain ``chain``: the seed in the low word, the
    chain index added to the high word (chain 0 keeps the seed itself)."""
    return (int(seed) + (int(chain) << 32)) & 0xFFFFFFFFFFFFFFFF


def init_chain_states(
    problem: sm.Problem, n_chains: int, seed: Optional[int] = None
) -> sm.SamplerState:
    """Batched initial state: one shared init, per-chain Philox keys.
    Span ``setup.states``, which with tracing on ends in a sync of a CUDA
    device."""
    with metrics.span("setup.states", sync=problem.device):
        state0 = sm.init_state(problem)
        base = problem.config.seed if seed is None else seed
        batched = stack_chains([state0] * n_chains)
        keys = [chain_key(base, c) for c in range(n_chains)]
        # int64 holds the 64-bit key pattern (two's complement)
        batched.key = torch.tensor(
            [k - (1 << 64) if k >= 1 << 63 else k for k in keys],
            dtype=torch.int64, device=problem.device,
        )
        return batched


def segment_bytes_per_chain(problem: sm.Problem) -> int:
    """Device bytes one more chain adds to a batched segment: the segment's
    λ-last copies of its residual, clean cube and accumulators, the new
    state's λ-first copies, and the kernel scratch (float32)."""
    p = problem
    cube = p.L * p.Yc * p.Xc
    resid = p.L * p.Hp * p.Wp
    scratch = 3 * p.ny * p.nx * p.L          # about either kernel's
    return 4 * (2 * resid + 6 * cube + scratch)


def device_free_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA device (``torch.cuda.mem_get_info``); None —
    no limit — elsewhere."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def max_chain_batch(problem: sm.Problem, n_chains: int) -> int:
    """Chains per batched segment: all of them, unless their working set
    (:func:`segment_bytes_per_chain` each) exceeds the free device memory."""
    free = device_free_bytes(problem.device)
    if free is None:
        return max(1, n_chains)
    fit = free // segment_bytes_per_chain(problem)
    return int(max(1, min(n_chains, fit)))


def _check_direct_chains(problem: sm.Problem, n_chains: int) -> None:
    """The JAX package's refusal of several direct chains at full-field
    scale (``deconv3d_tpu/chains.py:297-335``), with the card's free memory
    as the threshold in place of the v5e's 6 GiB PCG budget: the chains'
    draws run one after the other, so one draw's working set
    (``ops.direct.draw_bytes``) must fit beside the states."""
    from .ops.direct import draw_bytes

    free = device_free_bytes(problem.device)
    if n_chains > 1 and free is not None and draw_bytes(problem) > free:
        raise ValueError(
            "n_chains > 1 with sampler='direct' at full-field scale: each "
            "chain holds cube-size accumulators the PCG's memory does not "
            "have beside them — and direct draws are iid (every draw is one "
            "full ESS unit; R-hat across chains is trivially 1), so chains "
            "add nothing a longer single run doesn't.  Use n_chains=1 with "
            "more max_iterations.")


def to_device(obj, device):
    """A dataclass of tensors (nested ones too) with every tensor on
    ``device``."""
    return _fieldwise(lambda vals: vals[0].to(device), [obj])


def run_chains(
    problem: sm.Problem,
    n_chains: int,
    n_sweeps: Optional[int] = None,
    mesh=None,
    states: Optional[sm.SamplerState] = None,
    axis_name: str = "chains",
    spatial_axis: Optional[str] = None,
) -> MultiChainResult:
    """Run ``n_chains`` independent chains in lockstep, batched.

    One ``sampler.run_sweeps`` call for the whole batch (on a CUDA device:
    one kernel launch per sweep for all chains), or one per group of
    :func:`max_chain_batch` chains where the batch would not fit the card.
    Each chain keeps its Philox key (:func:`chain_key`), so it draws the
    same numbers in any batch.  ``sampler='direct'`` draws chain by chain
    (``ops.direct.direct_run_sweeps``); several chains raise where one
    draw's working set does not fit the card beside their states.

    ``mesh`` (``parallel.Mesh``) with the axis ``axis_name``: the chains
    split over its slots (``n_chains`` a multiple of their number), each
    slot's group a batch on its device against the problem's copy there;
    the results come back to the problem's device, bit-equal to the run
    without a mesh.  With ``spatial_axis`` set, ``mesh`` is 2-D
    ``(axis_name, spatial_axis)`` and each chain also Y-shards its sweep
    over its mesh row at kernel rate
    (``parallel.kernel_sharded.run_chains_kernel_sharded``).
    """
    if n_sweeps is None:
        n_sweeps = problem.config.max_iterations
    if spatial_axis is not None:
        from .parallel.kernel_sharded import run_chains_kernel_sharded

        if mesh is None:
            raise ValueError(
                "spatial_axis needs an explicit 2-D mesh "
                f"({axis_name!r}, {spatial_axis!r})")
        return run_chains_kernel_sharded(
            problem, n_chains, n_sweeps, mesh, states=states,
            chain_axis=axis_name, axis_name=spatial_axis)
    if problem.config.sampler == "direct":
        _check_direct_chains(problem, n_chains)
    if states is None:
        states = init_chain_states(problem, n_chains)
    if mesh is not None:
        return _run_chains_mesh(problem, n_chains, n_sweeps, mesh, states,
                                axis_name)
    return _run_chains_local(problem, n_chains, n_sweeps, states)


def _run_chains_mesh(problem, n_chains, n_sweeps, mesh, states, axis_name):
    from .parallel.sweep_sharded import mesh_axis

    devices = mesh_axis(mesh, axis_name)
    D = len(devices)
    if n_chains % D:
        raise ValueError(f"n_chains={n_chains} must be a multiple of the "
                         f"mesh's {axis_name!r} size {D}")
    per = n_chains // D
    results = []
    for d, (dev, mine) in enumerate(zip(devices, devices.local())):
        if not mine:                     # another rank runs this group
            results.append(None)
            continue
        p_d = problem if dev == problem.device else sm.cached(
            problem, ("on", str(dev)), lambda: problem.to(dev))
        group = to_device(select_chains(states, slice(d * per, (d + 1) * per)),
                          p_d.device)
        results.append(to_device(
            _run_chains_local(p_d, per, n_sweeps, group).result,
            problem.device))
    return MultiChainResult(result=results[0] if D == 1
                            else gather_chains(results, devices,
                                               problem.device))


def _run_chains_local(problem, n_chains, n_sweeps, states):
    cb = max_chain_batch(problem, n_chains)
    results = [
        sm.run_sweeps(problem, select_chains(states, slice(lo, lo + cb)),
                      n_sweeps)
        for lo in range(0, n_chains, cb)
    ]
    return MultiChainResult(
        result=results[0] if len(results) == 1
        else _fieldwise(torch.cat, results))
