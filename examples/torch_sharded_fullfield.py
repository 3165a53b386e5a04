"""Parallel topologies for big fields on the PyTorch port — the production
recipes.

The port's twin of ``sharded_fullfield.py``: the same small geometry and
settings through the four topologies.  A mesh here is a
``deconv3d_tpu_torch.parallel.Mesh`` of ``torch.device`` slots in place of
``jax.sharding.Mesh``: one card per slot where that many cards are visible
(``make_mesh``), else every slot on the one device — two shards of one
card run as two shards, with their exchanges, so all four topologies run
on one H100 (and on the CPU with ``--device cpu``; no ``XLA_FLAGS``
needed).  A full 300×300×3681 MUSE field fits ONE H100 on the tiled kernel
(``engine='auto'`` picks it), so several cards are for chains and for
latency — not capacity.

    1. chain parallelism            Run(n_chains=k, mesh=1-D mesh)
    2. spatial (one chain, Y-shard) Run(spatial_mesh=...)
    3. chains × spatial 2-D mesh    Run(n_chains=2, spatial_mesh=mesh2d)
    4. exact draws, Y-sharded PCG   Run(sampler='direct', spatial_mesh=...)

    python examples/torch_sharded_fullfield.py               # on the card
    python examples/torch_sharded_fullfield.py --device cpu  # plain torch

Without a card it raises unless ``--device cpu`` is given (no fallback).
"""

import argparse

import numpy as np
import torch

import deconv3d_tpu_torch as d3
from deconv3d_tpu_torch import instruments as ins
from deconv3d_tpu_torch.parallel import Mesh, make_mesh

F, L = 5, 32
Y, X = 4 * F, 2 * F                    # 4 color block-rows: shards over ≤2


def scene():
    """The JAX example's field: a point of 20 at the centre plus N(0, 0.1²)
    noise from ``default_rng(2)`` (variance 0.01), under a Gaussian FSF
    (FWHM 0.5″) and LSF (FWHM 2.0 Å) at 0.2″ pixels.  Returns the cube (on
    the CPU) and the instrument."""
    truth = np.zeros((L, Y, X), np.float32)
    truth[L // 2, Y // 2, X // 2] = 20.0
    inst = ins.Instrument(
        fsf=ins.GaussianFSF(fwhm=0.5), lsf=ins.GaussianLSF(fwhm=2.0),
        pixel_scale=0.2,
    )
    rng = np.random.default_rng(2)
    cube = d3.Cube.from_data(
        (truth + rng.normal(0, 0.1, truth.shape)).astype(np.float32),
        variance=np.full(truth.shape, 0.01, np.float32),
        crval=4750.0, cdelt=1.25,
    )
    return cube, inst


def mesh(device: torch.device, shape, axis_names) -> Mesh:
    """A mesh of ``shape`` slots: the first cards where enough are visible,
    else every slot on ``device``."""
    n = int(np.prod(shape))
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        slots = list(make_mesh(n, axis_names[0]).devices)
    else:
        slots = [device] * n
    if len(shape) == 2:
        slots = [slots[r * shape[1]:(r + 1) * shape[1]]
                 for r in range(shape[0])]
    return Mesh(slots, axis_names)


def main(device="cuda", max_iterations=40):
    """Run the four topologies; return their printed figures (and the
    ``Run`` of each)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') "
                           "to run the plain torch versions on the CPU")
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"{n_cards} cards ({device.type})")
    cube, inst = scene()
    n_vox = L * Y * X
    kw = dict(max_iterations=max_iterations, burn_in=max_iterations // 4,
              fsf_size=F, lsf_width=5, device=device)
    out, runs = {}, {}

    # --- 1. chain parallelism: independent chains, one per slot ----------
    chains = mesh(device, (max(2, n_cards),), ("chains",))
    run = d3.Run(cube, inst, n_chains=chains.shape["chains"], mesh=chains,
                 **kw)
    run.run()
    out["chains"] = run.diagnostics()
    runs["chains"] = run
    print("chains        :", out["chains"])

    # --- 2. one chain's sweep Y-sharded over 2 slots (huge single fields) -
    # On the card each shard's sweep is the tiled kernel's band launches.
    run_sp = d3.Run(cube, inst, spatial_mesh=mesh(device, (2,), ("sp",)),
                    **kw)
    run_sp.run()
    out["spatial"] = run_sp.chi2 / n_vox
    runs["spatial"] = run_sp
    print(f"spatial       : chi2/dof {out['spatial']:.3f}")

    # --- 3. 2 chains × 2-way spatial on a 2-D mesh ------------------------
    # coarse_every composes with every topology: globally-coherent pattern
    # passes (exact Gibbs along the blur-null directions) interleave at
    # absolute-sweep boundaries on each chain.  'cuda_tiled' / 'torch_tiled'
    # are the port's names for the JAX package's 'pallas_tiled'.
    mesh2d = mesh(device, (2, 2), ("chains", "sp"))
    tiled = "cuda_tiled" if device.type == "cuda" else "torch_tiled"
    run_2d = d3.Run(cube, inst, n_chains=2, spatial_mesh=mesh2d,
                    engine=tiled, coarse_every=8, **kw)
    run_2d.run()
    out["chains_x_spatial"] = run_2d.chi2 / n_vox
    out["chains_x_spatial_chains"] = int(run_2d.states.clean.shape[0])
    runs["chains_x_spatial"] = run_2d
    print("chains×spatial: chi2/dof "
          f"{out['chains_x_spatial']:.3f}  "
          f"chains {out['chains_x_spatial_chains']}")

    # --- 4. exact (iid) posterior draws over the mesh ---------------------
    # The direct sampler has no sweep structure to decompose: its PCG cuts
    # every vector along Y, one slot a block of rows, with halo exchanges
    # for the FSF and an all-to-all around the preconditioner, whose solve
    # is one banded-solve launch per slot (parallel/direct_sharded.py).
    # Not gated as in the JAX example (an XLA limitation there): it runs on
    # the CPU and on the card alike.
    run_d = d3.Run(cube, inst, sampler="direct",
                   spatial_mesh=mesh(device, (2,), ("sp",)),
                   max_iterations=min(8, max_iterations), fsf_size=F,
                   lsf_width=5, device=device)
    run_d.run()
    out["sharded_direct"] = run_d.chi2 / n_vox
    runs["sharded_direct"] = run_d
    print(f"sharded direct: chi2/dof {out['sharded_direct']:.3f}")
    out["runs"] = runs
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    main(parser.parse_args().device)
