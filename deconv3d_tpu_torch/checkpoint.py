"""Checkpoint / resume of sampler state (NPZ).

Counterpart of the NPZ backend of ``deconv3d_tpu/checkpoint.py``: the full
sampler state — including the chain's Philox key and absolute sweep
counter — goes into one NPZ, so a checkpoint is a complete, bit-exact
resume point.  The orbax backend is not ported.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from .sampler import SamplerState


def _normalize(path: str) -> str:
    """np.savez appends '.npz' to extensionless paths; load must match."""
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: SamplerState, meta: dict | None = None) -> None:
    names = [f.name for f in dataclasses.fields(state)]
    payload = {
        f"field_{n}": getattr(state, n).detach().cpu().numpy() for n in names
    }
    payload["fields"] = np.array(json.dumps(names))
    payload["meta"] = np.array(json.dumps(meta or {}))
    np.savez(_normalize(path), **payload)


def load_state(path: str, like: SamplerState) -> Tuple[SamplerState, dict]:
    """Restore state into the structure of ``like`` (shape/device template)."""
    names = [f.name for f in dataclasses.fields(like)]
    with np.load(_normalize(path)) as z:
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
        meta = json.loads(str(z["meta"]))
    return SamplerState(**out), meta
