"""Checkpoint / resume of sampler state.

Counterpart of ``deconv3d_tpu/checkpoint.py``; a checkpoint holds the full
sampler state — every chain's Philox key and absolute sweep counter
included — so it is a complete, bit-exact resume point.

  * NPZ, one file (:func:`save_state` / :func:`load_state`): the state's
    fields by name.  :func:`load_state` also reads the JAX package's NPZ
    (its pytree leaves ``leaf_0`` … ``leaf_11`` and a ``treedef``), and a
    directory of the DCP backend below.
  * DCP, a directory (:func:`save_state_dcp` / :func:`load_state_dcp`):
    the counterpart of the JAX package's orbax backend on
    ``torch.distributed.checkpoint``.  Every rank of a process group calls
    it; the state, whole on every rank, is written once; the metadata is
    written last, so a save cut short does not load.

An orbax directory of the JAX package does not load here (reading orbax's
format needs orbax): :func:`load_state` raises a ``ValueError`` that says
how to carry it across.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Tuple

import numpy as np
import torch

from . import interop
from .sampler import SamplerState

#: the JAX package's ``SamplerState`` leaves in its flatten order
#: (``deconv3d_tpu/sampler.py:317-329``), which its NPZ numbers leaf_0 …
JAX_LEAVES = ("clean", "resid", "key", "chi2", "chi2_comp", "log_scale",
              "n_accept", "n_propose", "sum_clean", "sum_sq", "n_kept",
              "sweep")
#: the ``treedef`` its ``save_state`` writes for that state
JAX_TREEDEF = ("PyTreeDef(CustomNode(SamplerState[()], ["
               + ", ".join("*" * len(JAX_LEAVES)) + "]))")
#: files that only an orbax checkpoint directory holds
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")
#: the file DCP writes last, when a save has finished
_DCP_METADATA = ".metadata"


def _normalize(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; load must match."""
    return path if path.endswith(".npz") else path + ".npz"


def checkpoint_format(path: str) -> str:
    """What ``path`` holds: ``'npz'`` (this package's), ``'jax'`` (the JAX
    package's NPZ), ``'dcp'`` (a :func:`save_state_dcp` directory,
    finished or not) or ``'orbax'`` (the JAX package's orbax directory)."""
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, n)) for n in _ORBAX_FILES):
            return "orbax"
        if (os.path.exists(os.path.join(path, _DCP_METADATA))
                or glob.glob(os.path.join(path, "*.distcp"))):
            return "dcp"
        raise ValueError(f"{path} is a directory that holds no checkpoint")
    with np.load(_normalize(path)) as z:
        if "fields" in z.files:
            return "npz"
        if "treedef" in z.files:
            return "jax"
    raise ValueError(f"{_normalize(path)} is an NPZ of no known checkpoint "
                     "layout (neither 'fields' nor 'treedef')")


def save_state(path: str, state: SamplerState, meta: dict | None = None) -> None:
    names = [f.name for f in dataclasses.fields(state)]
    payload = {
        f"field_{n}": getattr(state, n).detach().cpu().numpy() for n in names
    }
    payload["fields"] = np.array(json.dumps(names))
    payload["meta"] = np.array(json.dumps(meta or {}))
    np.savez(_normalize(path), **payload)


def load_state(path: str, like: SamplerState) -> Tuple[SamplerState, dict]:
    """Restore state into the structure of ``like`` (shape/device template).

    ``path``: this package's NPZ, the JAX package's NPZ
    (:func:`_from_jax_leaves`: carried into ``like``'s chains, dtypes and
    device) or a DCP directory (:func:`load_state_dcp`).  An orbax
    directory raises ``ValueError``."""
    fmt = checkpoint_format(path)
    if fmt == "orbax":
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package "
            "(save_state_orbax); reading orbax's format needs orbax, which "
            "this package does not use.  Restore it with "
            "deconv3d_tpu.checkpoint.load_state_orbax and write it again "
            "with deconv3d_tpu.checkpoint.save_state (NPZ), which "
            "load_state reads.")
    if fmt == "dcp":
        return load_state_dcp(path, like)
    names = [f.name for f in dataclasses.fields(like)]
    with np.load(_normalize(path)) as z:
        meta = json.loads(str(z["meta"]))
        if fmt == "jax":
            return _from_jax_leaves(z, like), meta
        stored = json.loads(str(z["fields"]))
        if stored != names:
            raise ValueError(f"checkpoint fields {stored} != {names}")
        out = {}
        for n in names:
            want = getattr(like, n)
            got = z[f"field_{n}"]
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint field {n} shape {got.shape} != "
                    f"{tuple(want.shape)}"
                )
            out[n] = torch.as_tensor(got).to(want.device)
    return SamplerState(**out), meta


def _from_jax_leaves(z, like: SamplerState) -> SamplerState:
    """The JAX package's NPZ leaves as a state of ``like``'s layout.

    The leaves are ``SamplerState``'s fields in :data:`JAX_LEAVES` order.
    A JAX ``Run`` stores its chains stacked ``[C, …]`` (a bare state has
    no chain axis); they fill ``like``'s C chains, each JAX key (two
    uint32 words) becoming that chain's 64-bit Philox key
    (``interop.key_from_words``), ``sweep`` int64 and every other array
    ``like``'s dtype.  A chain count or geometry that differs from
    ``like``'s raises ``ValueError``.  χ² comes as the JAX run computed
    it, on its weights: ``Run.resume`` rebaselines it on the port's."""
    treedef = str(z["treedef"])
    if treedef != JAX_TREEDEF:
        raise ValueError(
            f"JAX checkpoint treedef {treedef} is not the SamplerState "
            f"layout this package reads, {JAX_TREEDEF}")
    leaves = {n: z[f"leaf_{i}"] for i, n in enumerate(JAX_LEAVES)}
    if leaves["clean"].ndim == 3:               # a bare state: one chain
        leaves = {n: a[None] for n, a in leaves.items()}
    stacked = like.clean.dim() == 4
    have = leaves["clean"].shape[0]
    want_c = like.clean.shape[0] if stacked else 1
    if have != want_c:
        raise ValueError(f"the JAX checkpoint holds {have} chain(s), the "
                         f"state to resume {want_c}")
    out = {}
    for fld in dataclasses.fields(SamplerState):
        want = getattr(like, fld.name)
        shape = tuple(want.shape) if stacked else (1, *want.shape)
        arr = leaves[fld.name]
        if fld.name == "key":
            keys = [interop.key_from_words(w) for w in arr.reshape(have, -1)]
            t = torch.tensor([k - (1 << 64) if k >= 1 << 63 else k
                              for k in keys], dtype=torch.int64)
        else:
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"JAX checkpoint leaf {fld.name} has shape {arr.shape}, "
                    f"the state to resume {shape}: another geometry")
            t = torch.as_tensor(np.asarray(arr)).to(
                torch.int64 if fld.name == "sweep" else want.dtype)
        out[fld.name] = (t if stacked else t[0]).to(want.device)
    return SamplerState(**out)


# ---------------------------------------------------------------------------
# DCP: torch.distributed.checkpoint, in place of the JAX package's orbax
# ---------------------------------------------------------------------------

def save_state_dcp(path: str, state: SamplerState, meta: dict | None = None,
                   async_: bool = False):
    """A directory checkpoint on ``torch.distributed.checkpoint`` (DCP):
    the twin of the JAX package's ``save_state_orbax``, without its format.

    Every rank of the process group (``parallel.multihost.initialize``)
    calls it with the same ``path`` on a file system they share, each with
    its copy of the state: a state is whole on every rank after a segment,
    so DCP's planner writes each tensor once, from one rank.  Without a
    process group it writes from this process alone.  ``meta`` is stored
    as JSON.  DCP writes the directory's metadata last, once every rank's
    data is written, and a save into an existing checkpoint first removes
    its metadata: a save cut short leaves a directory that does not load
    (:func:`load_state_dcp` raises).  ``async_=True`` stages the tensors
    to host memory, writes them in a background thread and returns
    ``dcp.async_save``'s future: the checkpoint is complete when its
    ``.result()`` returns (the JAX function returns its checkpointer,
    whose ``wait_until_finished()`` waits).  Else returns None, complete.
    """
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    group = dist.is_available() and dist.is_initialized()
    if not group or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        stale = os.path.join(path, _DCP_METADATA)
        if os.path.exists(stale):
            os.remove(stale)
    if group:
        dist.barrier()
    payload = {
        "state": {f.name: getattr(state, f.name)
                  for f in dataclasses.fields(state)},
        "meta": torch.tensor(list(json.dumps(meta or {}).encode()),
                             dtype=torch.uint8),
    }
    # without a process group DCP writes from this process alone
    if async_:
        return dcp.async_save(payload, checkpoint_id=path)
    dcp.save(payload, checkpoint_id=path)
    return None


def load_state_dcp(path: str, like: SamplerState) -> Tuple[SamplerState, dict]:
    """Restore a :func:`save_state_dcp` directory into the structure of
    ``like`` (the twin of ``load_state_orbax``): new tensors of ``like``'s
    shapes and dtypes on its device (each rank its own).  Raises
    ``ValueError`` where the save did not finish (no metadata) or the
    fields or shapes differ from ``like``'s."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    if not os.path.isfile(os.path.join(path, _DCP_METADATA)):
        raise ValueError(
            f"{path} holds no finished DCP checkpoint: its {_DCP_METADATA}, "
            "which DCP writes last, is missing (a save cut short or still "
            "running)")
    items = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    names = [f.name for f in dataclasses.fields(like)]
    stored = sorted(k[len("state."):] for k in items if k.startswith("state."))
    if stored != sorted(names):
        raise ValueError(f"DCP checkpoint fields {stored} != {sorted(names)}")
    for n in names:
        got, want = tuple(items[f"state.{n}"].size), tuple(getattr(like, n).shape)
        if got != want:
            raise ValueError(
                f"DCP checkpoint field {n} shape {got} != {want}")
    payload = {
        "state": {n: torch.empty_like(getattr(like, n)) for n in names},
        "meta": torch.empty(tuple(items["meta"].size), dtype=torch.uint8),
    }
    dcp.load(payload, checkpoint_id=path)
    meta = json.loads(bytes(payload["meta"].tolist()).decode())
    return SamplerState(**payload["state"]), meta
