"""Carry problems and states across packages as NumPy arrays.

``problem_from_numpy`` / ``state_from_numpy`` build the port's
:class:`~deconv3d_tpu_torch.sampler.Problem` / ``SamplerState`` from the
JAX package's leaves (any mapping of field name → array); ``*_to_numpy``
go the other way.  No JAX import: the caller hands over NumPy arrays, so
both packages can start from the identical state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import sampler as sm
from .cube import torch_dtype

_PROBLEM_INTS = ("L", "Y", "X", "f", "ny", "nx")
_PROBLEM_TENSORS = (
    "fsf", "lsf", "data_pad", "w_pad", "quad", "valid", "monitor_idx",
    "fsf_spec", "fsf_imgs", "qvox", "quad_lo", "chol", "quad_mean",
)
#: leaves that may be None (``qvox`` exists for ``sampler='gibbs'``,
#: ``quad_lo`` for ``'gibbs'`` and ``'gibbs_block'`` — the JAX package has
#: none —, ``chol`` for ``'gibbs_block'``; a direct problem has no
#: ``quad`` and no low-rank factors, but ``quad_mean``)
_OPTIONAL = ("quad", "fsf_spec", "fsf_imgs", "qvox", "quad_lo", "chol",
             "quad_mean")


def untiled_layout(qt: np.ndarray, ny: int, nx: int, f: int, tile,
                   L: int) -> np.ndarray:
    """Cube layout ``[L, ny·f, nx·f]`` of an array in the JAX tiled
    kernel's per-(color, tile) layout ``[f²·n_tiles, 1, ny_t·nx_t·Lp]``
    (λ padded to Lp): the inverse of ``tiled_quad_layout``."""
    ny_t, nx_t = tile
    n_ty, n_tx = ny // ny_t, nx // nx_t
    Lp = qt.size // (f * f * ny * nx)
    q = np.asarray(qt).reshape(f, f, n_ty, n_tx, ny_t, nx_t, Lp)
    # [Lp, n_ty, ny_t, f, n_tx, nx_t, f]: block row, row in block, ...
    return q.transpose(6, 2, 4, 0, 3, 5, 1).reshape(Lp, ny * f, nx * f)[:L]


def problem_from_numpy(d: Mapping, config: sm.RunConfig = sm.RunConfig(),
                       device="cpu") -> sm.Problem:
    """Port Problem from a mapping of field name → NumPy array / int.

    A JAX tiled problem (``engine='pallas_tiled'``) carries ``quad`` and
    ``qvox`` only as ``quad_tiled`` / ``qvox_tiled``, in the layout of
    ``config.tile``: they come back in the cube layout
    (:func:`untiled_layout`).  Its bfloat16 ``w_pad`` holds the same
    values as the port's float32 one (``Problem.w_bf16``: the weights'
    values round-trip through bfloat16).  Float arrays take
    ``config.dtype``."""
    fdt = torch_dtype(config.dtype)
    kw = {n: int(d[n]) for n in _PROBLEM_INTS}
    d = dict(d)
    for n in ("quad", "qvox"):
        if d.get(n) is None and d.get(f"{n}_tiled") is not None:
            if config.tile is None:
                raise ValueError(f"{n}_tiled needs config.tile")
            d[n] = untiled_layout(np.asarray(d[f"{n}_tiled"]), kw["ny"],
                                  kw["nx"], kw["f"], config.tile, kw["L"])
    for n in _PROBLEM_TENSORS:
        if n in _OPTIONAL and d.get(n) is None:
            kw[n] = None
            continue
        arr = np.asarray(d[n])
        if arr.dtype == bool:
            dtype = torch.bool
        elif np.issubdtype(arr.dtype, np.integer):
            dtype = torch.int64
        else:                        # float32, float64, bfloat16 values
            arr, dtype = arr.astype(
                np.float64 if fdt == torch.float64 else np.float32), fdt
        kw[n] = torch.tensor(arr, dtype=dtype, device=device)
    w = kw["w_pad"]
    return sm.Problem(config=config, **kw, w_bf16=bool(
        (w.to(torch.bfloat16).to(w.dtype) == w).all()))


#: the JAX package's engines → the port's CPU engines
_ENGINES = {"jnp": "torch", "pallas": "torch", "pallas_tiled": "torch_tiled"}


def config_from_mapping(d: Mapping) -> sm.RunConfig:
    """Port RunConfig from a mapping of the JAX package's RunConfig fields
    (``dataclasses.asdict`` of a resolved config): the fields the port has,
    its engines mapped to the port's CPU ones.  A JAX ``make_problem`` has
    resolved ``prior_precision`` and ``direct_precond_tau`` to floats; they
    carry across as such."""
    names = {f.name for f in dataclasses.fields(sm.RunConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "engine" in kw:
        kw["engine"] = _ENGINES.get(kw["engine"], kw["engine"])
    if kw.get("tile") is not None:
        kw["tile"] = tuple(int(t) for t in kw["tile"])
    return sm.RunConfig(**kw)


def problem_to_numpy(problem: sm.Problem) -> dict:
    out = {n: getattr(problem, n) for n in _PROBLEM_INTS}
    for n in _PROBLEM_TENSORS:
        t = getattr(problem, n)
        out[n] = None if t is None else t.cpu().numpy()
    return out


def key_from_words(words) -> int:
    """64-bit Philox key from a 2-word uint32 key (high word first, as a
    JAX ``PRNGKey(seed)`` holds ``[0, seed]``) or from a scalar."""
    w = np.asarray(words).astype(np.uint64).reshape(-1)
    if w.size == 1:
        return int(w[0])
    return int((w[0] << np.uint64(32)) | w[1])


#: the state's float32 bookkeeping scalars (the cubes take the run's dtype)
_STATE_FLOAT32 = ("chi2", "chi2_comp", "n_accept", "n_propose", "n_kept")


def state_from_numpy(d: Mapping, device="cpu",
                     dtype=torch.float32) -> sm.SamplerState:
    """Port SamplerState from a mapping of field name → NumPy array; the
    cubes and log-scales take ``dtype``, χ² and the counts float32."""
    kw = {}
    for fld in dataclasses.fields(sm.SamplerState):
        arr = np.asarray(d[fld.name])
        if fld.name == "key":
            key = key_from_words(arr)
            key = key - (1 << 64) if key >= 1 << 63 else key
            kw["key"] = torch.tensor(key, dtype=torch.int64, device=device)
        elif fld.name == "sweep":
            kw["sweep"] = torch.tensor(int(arr), dtype=torch.int64, device=device)
        else:
            kw[fld.name] = torch.tensor(
                arr, device=device,
                dtype=torch.float32 if fld.name in _STATE_FLOAT32 else dtype)
    return sm.SamplerState(**kw)


def state_to_numpy(state: sm.SamplerState) -> dict:
    return {
        fld.name: getattr(state, fld.name).cpu().numpy()
        for fld in dataclasses.fields(state)
    }
