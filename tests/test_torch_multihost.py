"""The port over several processes (``parallel/multihost.py``): 2 real OS
processes on ``gloo``, 2 CPU slots each, against the one-process mesh of
the same 4 slots.

Twins of the JAX package's ``tests/test_multihost.py`` (the global mesh's
slot order, collectives across the ranks, ``initialize``'s idempotence and
its failure) and of its three ``test_multihost_2proc*.py`` (the plain
sharded sweep, the kernel-rate band sweep with a coarse pass, a (chains,
spatial) mesh whose chain rows sit on different ranks), plus ``Run`` with
a global mesh and the sharded direct draws and MAP.  Every result is the
one-process run of the same slots bit for bit, on every rank; that run is
held against the JAX package by ``tests/test_torch_parallel.py`` and
``tests/test_torch_direct_sharded.py`` (the JAX package's own 2-process
test allows 1e-12 there).

One spawn of the 2 ranks runs every check (this file run as a script: the
ranks import ``deconv3d_tpu_torch`` and nothing of JAX), while the parent
computes the one-process references; each test then reads its check.  A
``gpu`` test runs the band kernel across 2 ranks on one card.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import sampler as sm
from deconv3d_tpu_torch.parallel import Mesh, mesh as pm, multihost as mh
from deconv3d_tpu_torch.parallel import direct_sharded as ds
from deconv3d_tpu_torch.parallel import kernel_sharded as ks
from deconv3d_tpu_torch.parallel import sweep_sharded as ss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
#: ranks, and slots per rank
RANKS, SLOTS = 2, 2
#: seconds a rank waits for its peer in any collective; the parent's limit
RANK_TIMEOUT_S, SPAWN_TIMEOUT_S = 60, 240


# ---------------------------------------------------------------------------
# The checks, run on any mesh of 4 slots (the ranks' global one, or one
# process's)
# ---------------------------------------------------------------------------

def _cube(seed, Y, X, L, f=5, dtype=np.float64, noise=0.2):
    rng = np.random.default_rng(seed)
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    truth[L // 3, 2, 2] = 3.0
    data = (truth + noise * rng.standard_normal(truth.shape)).astype(dtype)
    return d3.Cube.from_data(data, variance=np.full_like(data, noise**2),
                             crval=4750.0, cdelt=1.25, dtype=dtype)


def _inst():
    return ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)


def _problem(dtype=np.float64, Y=40, X=10, f=5, **cfg):
    """8 × 2 spaxel blocks of f = 5: 2 block rows a slot over 4 slots."""
    kw = dict(max_iterations=30, burn_in=2, seed=4, fsf_size=f, lsf_width=5,
              dtype=dtype)
    kw.update(cfg)
    return sm.make_problem(_cube(42, Y, X, 16, f, dtype), _inst(),
                           sm.RunConfig(**kw), device="cpu")


def _uniforms(p, n, sampler, seed=7):
    per = (p.L + 1,) if sampler == "mh" else (2, p.L)
    u = np.random.default_rng(seed).random((n, p.n_colors, p.ny * p.nx,
                                            *per))
    return torch.as_tensor(np.clip(u, 2.0**-24, 1 - 2.0**-24))


def _flat(obj, prefix=""):
    """A dataclass or named tuple (nested), tensor or number as {name:
    value}."""
    names = ([f.name for f in dataclasses.fields(obj)]
             if dataclasses.is_dataclass(obj) else getattr(obj, "_fields",
                                                           None))
    if names is None:
        return {prefix.rstrip("."): obj}
    out = {}
    for name in names:
        out.update(_flat(getattr(obj, name), f"{prefix}{name}."))
    return out


def _collectives(slots):
    """Every collective of ``parallel/mesh.py`` on the 4 slots, this
    process's parts of seeded tensors; the results of this process's
    slots."""
    g = torch.Generator().manual_seed(0)
    full = [torch.randn(4, 8, 12, generator=g, dtype=torch.float64)
            for _ in range(4)]
    ragged = [torch.randn(4, k, 12, generator=g, dtype=torch.float64)
              for k in (1, 3, 2, 2)]
    mine = slots.local()
    parts = [t if m else None for t, m in zip(full, mine)]
    rparts = [t if m else None for t, m in zip(ragged, mine)]
    R = slots.ranks
    out = {}
    for name, got in (
            ("ppermute+1", pm.ppermute(parts, 1, R)),
            ("ppermute-1", pm.ppermute(parts, -1, R)),
            ("psum", pm.psum(parts, R)),
            ("all_to_all", pm.all_to_all(parts, 1, 0, R)),
            ("all_to_all_ragged", pm.all_to_all_ragged(parts, 2, 1,
                                                       [5, 0, 4, 3], R)),
            ("all_to_all_ragged_uneven", pm.all_to_all_ragged(
                rparts, 2, 1, [2, 3, 3, 4], R))):
        out.update({f"{name}.{i}": t for i, t in enumerate(got)
                    if t is not None})
    out["slot_sum"] = pm.slot_sum(parts, R)
    out["gather"] = pm.gather(parts, CPU, 1, R)
    out["gather_uneven"] = pm.gather(rparts, CPU, 1, R)
    out.update({f"split.{i}": t for i, t in enumerate(
        pm.split(full[0], slots, 1)) if t is not None})
    return out


def _sweeps(sampler, mesh):
    p = _problem(sampler=sampler)
    u = _uniforms(p, 3, sampler)
    return ss.run_sweeps_sharded(p, sm.init_state(p), 3, mesh, uniforms=u)


def _kernel_sharded_coarse(mesh):
    """The band sweeps (plain version) with a global coarse pass after
    absolute sweeps 3 and 6, and a χ² rebaseline every 4 sweeps."""
    p = _problem(dtype=np.float32, X=20, coarse_every=3,
                 coarse_mode="global", chi2_rebaseline_every=4)
    return ks.run_sweeps_kernel_sharded(p, sm.init_state(p), 7, mesh,
                                        interior="torch")


def _chains_x_spatial(mesh2d):
    p = _problem(dtype=np.float32, X=20, coarse_every=3,
                 coarse_mode="global")
    states = ch.init_chain_states(p, 2)
    return ks.run_chains_kernel_sharded(p, 2, 4, mesh2d, states=states,
                                        interior="torch").result


def _run_chains_mesh(chains_mesh):
    p = _problem(sampler="gibbs")
    return ch.run_chains(p, 4, 3, mesh=chains_mesh).result


def _run_facade(spatial_mesh=None, mesh=None, n_chains=1):
    cube = _cube(3, 40, 10, 16, dtype=np.float32)
    r = d3.Run(cube, _inst(), max_iterations=5, burn_in=2, fsf_size=5,
               lsf_width=5, device="cpu", spatial_mesh=spatial_mesh,
               mesh=mesh, n_chains=n_chains, segment_size=3)
    r.run()
    d = r.diagnostics()
    return {**_flat(r.states, "state."), "chi2_trace": torch.as_tensor(
        r.trace("chi2")), "monitor_trace": torch.as_tensor(r.trace(
            "monitor")), "diagnostics": repr(sorted(d.items()))}


def _direct(mesh):
    """3 draws (Philox normals) and the MAP in float64, the MAP of a
    float32 problem (its float64 refinement): rows 4, 4, 3, 3 over the 4
    slots, thinner than h = 4 in two of them."""
    out = {}
    p = _problem(f=9, Y=14, X=10, sampler="direct", prior_precision=0.3)
    r = ds.run_direct_sweeps_sharded(p, sm.init_state(p), 3, mesh)
    out.update(_flat(r, "draws."))
    m = ds.posterior_mean_sharded(p, mesh, tol=1e-8)
    out.update(_flat(m, "map64."))
    p32 = _problem(np.float32, f=9, Y=14, X=10, sampler="direct",
                   prior_precision=0.3)
    m32 = ds.posterior_mean_sharded(p32, mesh, tol=1e-7)
    out.update(_flat(m32, "map32."))
    return out


def _checks(sp, chains, mesh2d):
    """Every check's results on the meshes of the 4 slots (``sp`` and
    ``chains`` 1-D, ``mesh2d`` (ch, sp) of 2 × 2), as {check: {name:
    value}}."""
    out = {"collectives": _collectives(sp.rows("sp")[0])}
    for sampler in ("mh", "gibbs", "gibbs_block"):
        out[f"sweeps_sharded_{sampler}"] = _flat(_sweeps(sampler, sp))
    out["kernel_sharded_coarse"] = _flat(_kernel_sharded_coarse(sp))
    out["chains_x_spatial"] = _flat(_chains_x_spatial(mesh2d))
    out["run_chains_mesh"] = _flat(_run_chains_mesh(chains))
    out["run_spatial_mesh"] = _run_facade(spatial_mesh=sp)
    out["run_mesh"] = _run_facade(mesh=chains, n_chains=4)
    out["direct"] = _direct(sp)
    return out


def _one_process_meshes():
    return (Mesh([CPU] * 4, ("sp",)), Mesh([CPU] * 4, ("chains",)),
            Mesh([[CPU] * 2] * 2, ("ch", "sp")))


def _global_meshes():
    sp = mh.global_mesh("sp", local_devices=[CPU] * SLOTS)
    chains = mh.global_mesh("chains", local_devices=[CPU] * SLOTS)
    mesh2d = Mesh(sp.devices.reshape(RANKS, SLOTS), ("ch", "sp"),
                  ranks=sp.ranks.reshape(RANKS, SLOTS))
    return sp, chains, mesh2d


# ---------------------------------------------------------------------------
# A rank (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, store: str, out: str, device: str) -> None:
    torch.set_num_threads(1)
    mh.initialize(f"file://{store}", RANKS, rank, backend="gloo",
                  timeout=RANK_TIMEOUT_S)
    group = torch.distributed.group.WORLD
    mh.initialize()                      # a no-op: the group stays
    mh.initialize(f"file://{store}.other", 5, 3)
    init = {"idempotent": torch.distributed.group.WORLD is group
            and torch.distributed.get_world_size() == RANKS
            and torch.distributed.get_rank() == rank}
    if device == "cuda":
        results = {"band_sweeps": _band_sweeps_on_card(
            mh.global_mesh("sp", local_devices=["cuda:0"]))}
    else:
        sp, chains, mesh2d = _global_meshes()
        init["mesh"] = (repr(sp.devices.tolist()), sp.ranks.tolist(),
                        [s.local() for s in sp.rows("sp")])
        results = _checks(sp, chains, mesh2d)
    torch.save({"init": init, "results": results}, out)
    torch.distributed.destroy_process_group()


def _spawn(tmp_path, device="cpu"):
    """The 2 ranks, started together; their outputs once both end (both
    killed if one fails or the limit passes)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{r}.pt" for r in range(RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(store),
         str(outs[r]), device], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    return procs, outs


def _collect(procs, outs):
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        assert pr.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(the ranks' outputs, the one-process references), one spawn for
    the whole file; the parent computes the references meanwhile."""
    procs, outs = _spawn(tmp_path_factory.mktemp("ranks"))
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            want = _checks(*_one_process_meshes())
        finally:
            torch.set_num_threads(n)
    except BaseException:
        for pr in procs:
            pr.kill()
            pr.communicate()
        raise
    return _collect(procs, outs), want


CHECKS = ["collectives", "sweeps_sharded_mh", "sweeps_sharded_gibbs",
          "sweeps_sharded_gibbs_block", "kernel_sharded_coarse",
          "chains_x_spatial", "run_chains_mesh", "run_spatial_mesh",
          "run_mesh", "direct"]


def _assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: {name}"
        else:
            assert g == w, f"{what}: {name}"


# ---------------------------------------------------------------------------
# Twins of tests/test_multihost.py
# ---------------------------------------------------------------------------

def test_global_mesh_spans_both_ranks_in_process_order(two_ranks):
    """The slot order of ``jax.devices()``: rank 0's slots, then rank 1's;
    each rank owns its own."""
    ranks, _ = two_ranks
    for r, out in enumerate(ranks):
        devices, owners, local = out["init"]["mesh"]
        assert owners == [0, 0, 1, 1]
        assert devices == repr([CPU] * 4)
        assert local == [[o == r for o in owners]]


def test_initialize_is_idempotent(two_ranks, tmp_path):
    """A second ``initialize`` (no arguments, or another store and world)
    leaves the group as it is; one process comes up alone on a file store
    and a later call is a no-op."""
    ranks, _ = two_ranks
    assert all(out["init"]["idempotent"] for out in ranks)
    code = (
        "import torch, torch.distributed as dist\n"
        "from deconv3d_tpu_torch.parallel import multihost as mh\n"
        f"mh.initialize('file://{tmp_path}/one', 1, 0, backend='gloo')\n"
        "group = dist.group.WORLD\n"
        "mh.initialize()\n"
        "m = mh.global_mesh('sp', local_devices=['cpu'])\n"
        "assert dist.group.WORLD is group and dist.get_world_size() == 1\n"
        "assert m.ranks.tolist() == [0] and m.shape == {'sp': 1}\n"
        "print('ONE-PROCESS-OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(
        os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert "ONE-PROCESS-OK" in out.stdout, out.stderr[-2000:]


def test_initialize_raises_when_the_peer_never_comes(tmp_path):
    """A 2-process launch whose second rank never starts raises
    ``RuntimeError`` within its timeout (it never goes on alone)."""
    code = (
        "import time\n"
        "from deconv3d_tpu_torch.parallel import multihost as mh\n"
        "t = time.monotonic()\n"
        "try:\n"
        f"    mh.initialize('file://{tmp_path}/lonely', 2, 0, "
        "backend='gloo', timeout=3)\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', time.monotonic() - t, str(e)[:80])\n"
        "else:\n"
        "    print('DID-NOT-RAISE')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(
        os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=120)
    assert out.stdout.startswith("RAISED"), (out.stdout, out.stderr[-2000:])
    assert float(out.stdout.split()[1]) < 3 + 30


def test_global_mesh_without_a_card_raises(monkeypatch):
    """The default slots are this rank's card: without one it raises (it
    never takes the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="does not exist"):
        mh.global_mesh()
    with pytest.raises(RuntimeError, match="does not exist"):
        mh.process_local_devices()


# ---------------------------------------------------------------------------
# Every check across the ranks == the one-process mesh, on every rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", CHECKS)
def test_two_ranks_match_one_process(two_ranks, check):
    """Collectives, the sharded sweeps (mh, gibbs, gibbs_block on injected
    uniforms), the band sweeps with coarse passes and rebaselines, the
    chain rows of a 2 × 2 mesh on different ranks, ``run_chains(mesh=)``,
    ``Run(spatial_mesh=)``, ``Run(mesh=)`` and the direct draws and MAP:
    bit-equal to the one-process run of the same 4 slots."""
    ranks, want = two_ranks
    for r, out in enumerate(ranks):
        if check == "collectives":
            # a rank holds its own slots' parts of the sharded results
            mine = {k: v for k, v in want[check].items()
                    if "." not in k or int(k.rsplit(".", 1)[1]) // SLOTS == r}
            _assert_same(out["results"][check], mine, f"rank {r}")
        else:
            _assert_same(out["results"][check], want[check], f"rank {r}")


@pytest.mark.parametrize("check", CHECKS[1:])
def test_ranks_end_with_identical_states(two_ranks, check):
    """Every rank holds the whole result, bit-identical to the others'
    (and the checks are not vacuous: the chains moved)."""
    ranks, _ = two_ranks
    first = ranks[0]["results"][check]
    for out in ranks[1:]:
        _assert_same(out["results"][check], first, check)
    moved = [k for k in first if k.endswith("n_accept") or k.endswith(
        "iterations")]
    assert moved and all(float(torch.as_tensor(first[k]).sum()) > 0
                         for k in moved), check


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _band_sweeps_on_card(mesh):
    """MH 2 sweeps and gibbs 1 sweep through the band launches at
    136×68×600 (f = 17): states of both."""
    from deconv3d_tpu_torch.ops import tiled as tl

    rng = np.random.default_rng(0)
    L, Y, X = 600, 136, 68
    truth = np.zeros((L, Y, X), np.float32)
    truth[300, 15, 15] = 50.0
    truth[200, 8, 20] = 30.0
    data = truth + rng.standard_normal((L, Y, X)).astype(np.float32)
    cube = d3.Cube.from_data(data, variance=np.ones_like(data),
                             crval=4750.0, cdelt=1.25, device="cuda")
    out = {}
    for sampler, n in (("mh", 2), ("gibbs", 1)):
        p = sm.make_problem(cube, d3.MUSE(), sm.RunConfig(
            seed=0, sampler=sampler), device="cuda")
        counter = tl.band_gibbs if sampler == "gibbs" else tl.band_mh
        n0 = counter.launches
        r = ks.run_sweeps_kernel_sharded(p, sm.init_state(p), n, mesh,
                                         interior="cuda")
        out.update({f"{sampler}.{k}": v.cpu() if isinstance(
            v, torch.Tensor) else v for k, v in _flat(r).items()})
        out[f"{sampler}.launches"] = counter.launches - n0
    return out


@pytest.mark.gpu
def test_two_ranks_band_kernel_on_one_card(tmp_path):
    """2 ranks on ``cuda:0`` (gloo, staged through the host), each
    launching the band kernel of ``csrc/tiled_sweep.cu`` on its shard:
    bit-equal to the one-process ``Mesh([cuda:0] * 2)`` run, 3 launches a
    sweep on every rank.  Full size: chip_smoke.py phase ``multihost``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernel has no CPU mode")
    procs, outs = _spawn(tmp_path, "cuda")
    try:
        dev = torch.device("cuda", 0)
        want = _band_sweeps_on_card(Mesh([dev, dev], ("sp",)))
    except BaseException:
        for pr in procs:
            pr.kill()
            pr.communicate()
        raise
    ranks = _collect(procs, outs)
    for r, out in enumerate(ranks):
        got = out["results"]["band_sweeps"]
        assert got["mh.launches"] == 3 * 2 and got["gibbs.launches"] == 3
        for k in got:
            if not k.endswith("launches"):
                assert torch.equal(got[k], want[k]), f"rank {r}: {k}"


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
