"""Checkpoints in the port: the JAX package's NPZ read by ``load_state`` and
``Run.resume``, the DCP backend in place of orbax, and the NPZ of a run
over 2 ranks.

  * JAX ``Run`` checkpoints (its own ``checkpoint.save_state``, 1 and 3
    chains, float64 and float32) load into the port's state equal, field
    by field, to ``interop.state_from_numpy`` of the leaves; ``resume``
    rebaselines χ² on the port's weights and the run continues with χ²
    consistency ≤ 1e-5; another geometry, chain count or ``treedef``
    raises ``ValueError``, and so does an orbax directory.
  * ``save_state_dcp`` / ``load_state_dcp``, the twins of the JAX tests
    ``tests/test_run_api.py::test_orbax_checkpoint_roundtrip`` and
    ``_async``: bit-exact round trips (key, sweep and meta included), a
    directory without its metadata does not load.
  * 2 real processes on gloo (this file run as a script: ``python
    tests/test_torch_checkpoint.py <rank> <store> <out> <dir>``; the ranks
    import nothing of JAX): DCP save and load on both ranks, each tensor
    written once; ``Run(checkpoint_path=…)`` over the 2-rank mesh writes
    its NPZ from rank 0 alone, and the NPZ resumes bit-exact.

JAX is imported inside the tests that use it.
"""

import dataclasses
import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import chains as ch
from deconv3d_tpu_torch import checkpoint as ckpt
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch import interop
from deconv3d_tpu_torch import sampler as sm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [f.name for f in dataclasses.fields(sm.SamplerState)]
#: the JAX runs' sweeps, and the port's after a resume
JAX_SWEEPS, MORE = 2, 4
RANK_TIMEOUT_S, SPAWN_TIMEOUT_S = 60, 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Toys of a few thousand voxels: torch's intra-op threads cost more
    than they give, and under a parallel test run they contend with the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(Y=10, X=10, L=8, seed=0, noise=0.2):
    rng = np.random.default_rng(seed)
    truth = np.zeros((L, Y, X))
    truth[L // 2, Y // 2, X // 2] = 5.0
    data = truth + noise * rng.standard_normal(truth.shape)
    return data, np.full_like(data, noise**2)


KW = dict(fsf_size=5, lsf_width=5, max_iterations=JAX_SWEEPS, burn_in=1)


def _port_run(dtype, n_chains, Y=10, X=10, **kw):
    data, var = _data(Y, X)
    cube = d3.Cube.from_data(data.astype(dtype), variance=var.astype(dtype),
                             crval=4750.0, cdelt=1.25, dtype=dtype)
    inst = ins.Instrument(fsf=ins.GaussianFSF(fwhm=0.5),
                          lsf=ins.GaussianLSF(fwhm=2.0), pixel_scale=0.2)
    return d3.Run(cube, inst, n_chains=n_chains, dtype=dtype, device="cpu",
                  **{**KW, **kw})


def _same(a, b, names=NAMES):
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype and torch.equal(x, y), n


# ---------------------------------------------------------------------------
# The JAX package's NPZ
# ---------------------------------------------------------------------------

CASES = [(1, np.float64), (3, np.float64), (1, np.float32), (3, np.float32)]


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """The NPZ of a JAX ``Run`` after 2 sweeps, per (chains, dtype), and
    its leaves as NumPy arrays."""
    import deconv3d_tpu as jd
    from deconv3d_tpu import instruments as jins

    tmp = tmp_path_factory.mktemp("jax")
    out = {}
    for n_chains, dtype in CASES:
        data, var = _data()
        path = str(tmp / f"run_{n_chains}_{np.dtype(dtype).name}")
        run = jd.Run(
            jd.Cube.from_data(data.astype(dtype), variance=var.astype(dtype),
                              crval=4750.0, cdelt=1.25, dtype=dtype),
            jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                            lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
            n_chains=n_chains, dtype=dtype, checkpoint_path=path, **KW)
        run.run()
        leaves = {n: np.asarray(getattr(run.states, n)) for n in NAMES}
        out[n_chains, dtype] = (path + ".npz", leaves)
    return out


def _carried(leaves, n_chains, dtype):
    """``interop.state_from_numpy`` of every chain's leaves, stacked."""
    return ch.stack_chains([interop.state_from_numpy(
        {n: a[c] for n, a in leaves.items()},
        dtype=torch.float64 if dtype == np.float64 else torch.float32)
        for c in range(n_chains)])


@pytest.mark.parametrize("n_chains, dtype", CASES)
def test_load_state_reads_a_jax_run(jax_checkpoints, n_chains, dtype):
    """``load_state`` of a JAX ``Run``'s NPZ == ``interop.state_from_numpy``
    of its leaves (every field, dtype included); the meta carries."""
    path, leaves = jax_checkpoints[n_chains, dtype]
    assert ckpt.checkpoint_format(path) == "jax"
    like = _port_run(dtype, n_chains).states
    got, meta = ckpt.load_state(path, like)
    assert meta == {"sweeps_done": JAX_SWEEPS}
    want = _carried(leaves, n_chains, dtype)
    _same(got, want)
    assert got.sweep.tolist() == [JAX_SWEEPS] * n_chains
    if n_chains == 1:                     # a state without a chain axis
        one, _ = ckpt.load_state(path, ch.select_chains(like, 0))
        _same(one, ch.select_chains(want, 0))


@pytest.mark.parametrize("n_chains, dtype", CASES)
def test_resume_continues_a_jax_run(jax_checkpoints, n_chains, dtype):
    """``Run.resume`` of the JAX NPZ: the loaded state with χ² rebaselined
    on the port's problem (Kahan term 0), then 4 sweeps from the JAX
    run's absolute sweep, every chain's running χ² within 1e-5 of the
    from-scratch one."""
    path, leaves = jax_checkpoints[n_chains, dtype]
    run = _port_run(dtype, n_chains).resume(path)
    want = _carried(leaves, n_chains, dtype)
    _same(run.states, want, [n for n in NAMES
                             if n not in ("chi2", "chi2_comp")])
    _same(run.states, sm.rebaseline_chi2(run.problem, want))
    assert not run.states.chi2_comp.any()
    assert run.sweeps_done == JAX_SWEEPS
    run.run(MORE)
    assert run.sweeps_done == JAX_SWEEPS + MORE
    for c in range(n_chains):
        state = ch.select_chains(run.states, c)
        full = float(sm.full_chi2(run.problem, state))
        assert abs(float(state.chi2) - full) <= 1e-5 * full


def test_jax_checkpoint_mismatches_raise(jax_checkpoints, tmp_path):
    """Another geometry, another chain count and another ``treedef``
    raise ``ValueError`` naming what differs."""
    path, _ = jax_checkpoints[3, np.float64]
    with pytest.raises(ValueError, match="another geometry"):
        _port_run(np.float64, 3, Y=15).resume(path)
    with pytest.raises(ValueError, match="3 chain"):
        _port_run(np.float64, 2).resume(path)
    with np.load(path) as z:
        payload = dict(z)
    payload["treedef"] = np.array("PyTreeDef(CustomNode(Other[()], [*]))")
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **payload)
    with pytest.raises(ValueError, match="Other.*SamplerState"):
        _port_run(np.float64, 3).resume(bad)


def test_orbax_directory_raises(tmp_path):
    """A directory of the JAX package's ``save_state_orbax`` raises a
    ``ValueError`` that names orbax and the way across (NPZ)."""
    import deconv3d_tpu as jd
    from deconv3d_tpu import checkpoint as jckpt
    from deconv3d_tpu import instruments as jins
    from deconv3d_tpu import sampler as jsm

    data, var = _data()
    jp = jsm.make_problem(
        jd.Cube.from_data(data, variance=var, crval=4750.0, cdelt=1.25,
                          dtype=np.float64),
        jins.Instrument(fsf=jins.GaussianFSF(fwhm=0.5),
                        lsf=jins.GaussianLSF(fwhm=2.0), pixel_scale=0.2),
        jsm.RunConfig(fsf_size=5, lsf_width=5, dtype=np.float64))
    path = str(tmp_path / "ock")
    jckpt.save_state_orbax(path, jsm.init_state(jp), meta={"k": 1})
    assert ckpt.checkpoint_format(path) == "orbax"
    run = _port_run(np.float64, 1)
    with pytest.raises(ValueError, match="orbax.*save_state \\(NPZ\\)"):
        run.resume(path)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.load_state(path, ch.select_chains(run.states, 0))


# ---------------------------------------------------------------------------
# DCP, in one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moved_states():
    """2 chains 3 sweeps into a float64 MH run (distinct keys, sweep 3)."""
    run = _port_run(np.float64, 2, max_iterations=3)
    run.run()
    return run


@pytest.mark.parametrize("async_", [False, True])
def test_dcp_roundtrip_bit_exact(moved_states, tmp_path, async_):
    """``save_state_dcp`` then ``load_state_dcp``: every field bit-equal
    (keys and sweep included) and the meta, sync and async (the future's
    ``result()`` waits); ``load_state`` and ``Run.resume`` read the same
    directory."""
    state = moved_states.states
    path = str(tmp_path / "dcp")
    out = ckpt.save_state_dcp(path, state, meta={"sweeps_done": 3},
                              async_=async_)
    if async_:
        out.result()
    else:
        assert out is None
    assert ckpt.checkpoint_format(path) == "dcp"
    like = ch.init_chain_states(moved_states.problem, 2)
    got, meta = ckpt.load_state_dcp(path, like)
    assert meta == {"sweeps_done": 3}
    _same(got, state)
    assert not torch.equal(got.key[0], got.key[1])
    assert all(not torch.equal(getattr(like, n), getattr(state, n))
               for n in ("clean", "sweep"))        # like was a template
    _same(ckpt.load_state(path, like)[0], state)
    run = _port_run(np.float64, 2, max_iterations=3).resume(path)
    _same(run.states, state)


def test_dcp_without_metadata_does_not_load(moved_states, tmp_path):
    """A directory whose metadata is missing (a save cut short: DCP writes
    it last) raises ``ValueError``; a new save over a finished checkpoint
    removes the old metadata before it writes; another shape raises."""
    state = moved_states.states
    path = str(tmp_path / "dcp")
    ckpt.save_state_dcp(path, state)
    os.remove(os.path.join(path, ".metadata"))
    assert glob.glob(os.path.join(path, "*.distcp"))
    assert ckpt.checkpoint_format(path) == "dcp"
    with pytest.raises(ValueError, match="no finished DCP checkpoint"):
        ckpt.load_state_dcp(path, state)
    with pytest.raises(ValueError, match="no finished DCP checkpoint"):
        moved_states.resume(path)
    ckpt.save_state_dcp(path, state, meta={"again": True})
    assert ckpt.load_state_dcp(path, state)[1] == {"again": True}
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_state_dcp(path, ch.select_chains(state, 0))


# ---------------------------------------------------------------------------
# 2 ranks on gloo
# ---------------------------------------------------------------------------

def _nbytes(state):
    return sum(getattr(state, n).numel() * getattr(state, n).element_size()
               for n in NAMES)


def _rank_main(rank: int, store: str, out: str, tmp: str) -> None:
    """One rank: DCP save and load of 2 chains, then a ``Run`` over the
    2-rank mesh (one CPU slot each, 2 block rows a slot) with
    ``checkpoint_path``, resumed from its NPZ and continued against an
    unbroken run."""
    import torch.distributed as dist

    from deconv3d_tpu_torch.parallel import multihost as mh

    torch.set_num_threads(1)
    mh.initialize(f"file://{store}", 2, rank, backend="gloo",
                  timeout=RANK_TIMEOUT_S)
    res = {}
    src = _port_run(np.float64, 2, max_iterations=3)
    src.run()
    state = src.states
    for name, async_ in (("dcp_sync", False), ("dcp_async", True)):
        path = os.path.join(tmp, name)
        fut = ckpt.save_state_dcp(path, state, meta={"rank_free": 1},
                                  async_=async_)
        if async_:
            fut.result()
        got, meta = ckpt.load_state_dcp(
            path, ch.init_chain_states(src.problem, 2))
        _same(got, state)
        dist.barrier()
        res[name] = {"meta": meta, "files": {
            os.path.basename(f): os.path.getsize(f)
            for f in glob.glob(os.path.join(path, "*.distcp"))}}
    res["state_bytes"] = _nbytes(state)

    mesh = mh.global_mesh("sp", local_devices=["cpu"])
    npz = os.path.join(tmp, "run")
    calls = []
    save = ckpt.save_state

    def counted(*a, **k):
        calls.append(rank)
        return save(*a, **k)

    ckpt.save_state = counted
    try:
        first = _port_run(np.float32, 1, Y=20, max_iterations=6,
                          segment_size=3, spatial_mesh=mesh,
                          checkpoint_path=npz)
        first.run()
    finally:
        ckpt.save_state = save
    res["save_calls"] = len(calls)
    resumed = _port_run(np.float32, 1, Y=20, max_iterations=3,
                        segment_size=3, spatial_mesh=mesh).resume(npz)
    _same(resumed.states, first.states)
    resumed.run()
    whole = _port_run(np.float32, 1, Y=20, max_iterations=9,
                      segment_size=3, spatial_mesh=mesh)
    whole.run()
    _same(resumed.states, whole.states)
    res["state"] = {n: getattr(whole.states, n) for n in NAMES}
    torch.save(res, out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), OMP_NUM_THREADS="1")
    outs = [tmp / f"rank{r}.pt" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r),
         str(tmp / "store"), str(outs[r]), str(tmp)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
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
    return [torch.load(o, weights_only=False) for o in outs], tmp


def test_two_ranks_dcp_roundtrip(two_ranks):
    """Both ranks save and load the same directory, sync and async: each
    loads the state bit-equal (checked in the ranks) with the meta, and
    the tensors are written once: the data files hold one state's bytes,
    not two."""
    ranks, tmp = two_ranks
    for name in ("dcp_sync", "dcp_async"):
        files = [out[name]["files"] for out in ranks]
        assert files[0] == files[1] and len(files[0]) == 2, files
        assert all(out[name]["meta"] == {"rank_free": 1} for out in ranks)
        written = sum(files[0].values())
        assert ranks[0]["state_bytes"] <= written \
            < 1.5 * ranks[0]["state_bytes"], (written, ranks[0]["state_bytes"])


def test_two_ranks_run_checkpoint_resumes_bit_exact(two_ranks):
    """``Run(checkpoint_path=…)`` over the 2-rank mesh: rank 0 alone writes
    the NPZ after each of the 2 segments (rank 1 waits at the barrier); a
    new run resumed from it on both ranks == the written state, and 3 more
    sweeps == the unbroken 9-sweep run, on each rank (checked there) and
    across the ranks, bit for bit; the NPZ loads here too."""
    ranks, tmp = two_ranks
    assert [out["save_calls"] for out in ranks] == [2, 0]
    for n in NAMES:
        assert torch.equal(ranks[0]["state"][n], ranks[1]["state"][n]), n
    assert ckpt.checkpoint_format(str(tmp / "run")) == "npz"
    state, meta = ckpt.load_state(str(tmp / "run"), ch.init_chain_states(
        _port_run(np.float32, 1, Y=20).problem, 1))
    assert meta == {"sweeps_done": 6} and int(state.sweep[0]) == 6


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
