"""Several processes: one mesh over every rank's devices.

Counterpart of ``deconv3d_tpu/parallel/multihost.py``, on
``torch.distributed``.  The JAX package's version initialises
``jax.distributed`` and builds a mesh over ``jax.devices()``; XLA then puts
the cross-process collectives into every sharded program.  Here:

  * :func:`initialize` brings up the process group once (idempotent;
    ``torchrun``'s environment, a ``host:port`` TCP store or a ``file://``
    store), ``nccl`` for ranks on CUDA devices and ``gloo`` on the CPU.  A
    launch of several processes that cannot come up raises: it never
    goes on as one process, which would sample the whole problem on every
    rank and silently duplicate the results.
  * :func:`global_mesh` all-gathers the ranks' device lists and builds one
    :class:`~.mesh.Mesh` whose slots carry their owning rank, in the slot
    order of ``jax.devices()``: rank 0's devices first.
  * Every sharded entry point (``parallel/sweep_sharded.py``,
    ``kernel_sharded.py``, ``direct_sharded.py``, ``chains.run_chains``,
    ``Run``) takes such a mesh: each rank runs its own slots' work, the
    collectives of ``parallel/mesh.py`` cross the ranks, and every rank
    ends a call with the whole result, bit-equal to the one-process mesh of
    the same slots.

Launch: ``torchrun --nproc-per-node k prog.py`` with ``initialize()`` and
``global_mesh()`` in ``prog.py``; or, without a launcher, every process
calls ``initialize(address, k, rank)`` itself.  Two ranks on one card pass
``global_mesh(local_devices=[torch.device("cuda", 0)])``.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

#: seconds a rank waits for its peers, at start-up and in every collective
TIMEOUT_S = 300.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: float = TIMEOUT_S) -> None:
    """Join the process group, once (a no-op when one exists).

    With no arguments, ``torchrun``'s environment: ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; without those, one process.
    ``coordinator_address``: ``host:port`` (a TCP store that rank 0 hosts)
    or ``file://path`` (a file store).  ``backend`` None: ``nccl`` where a
    CUDA device is present, else ``gloo``.  ``timeout`` (s) bounds the
    start-up and every later collective.  A start-up that fails raises
    ``RuntimeError``."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    wait = datetime.timedelta(seconds=timeout)
    try:
        if coordinator_address is None:
            if num_processes != 1:
                raise ValueError(f"{num_processes} processes need a "
                                 "coordinator_address (or MASTER_ADDR)")
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=wait)
        else:
            url = (coordinator_address
                   if coordinator_address.startswith("file://")
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(backend, init_method=url,
                                    rank=process_id,
                                    world_size=num_processes, timeout=wait)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"torch.distributed did not come up for rank {process_id} of "
            f"{num_processes} ({backend}, {coordinator_address}): {e}"
        ) from e


def process_local_devices() -> List[torch.device]:
    """This rank's devices: its card, ``cuda:<LOCAL_RANK>``.  Raises where
    that card does not exist (it never takes another card or the CPU)."""
    index = int(os.environ.get("LOCAL_RANK", 0))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= have:
        raise RuntimeError(
            f"rank's card cuda:{index} does not exist ({have} CUDA "
            "device(s)); pass global_mesh(local_devices=[...]) to choose "
            "the devices")
    return [torch.device("cuda", index)]


def global_mesh(axis_name: str = "sp",
                local_devices: Optional[Sequence] = None) -> Mesh:
    """One 1-D mesh over every rank's devices, rank 0's first (the slot
    order of the JAX package's ``jax.devices()``).  ``local_devices``:
    this rank's slots (default :func:`process_local_devices`).  Without a
    process group, the mesh of this process's devices."""
    local = [torch.device(d) for d in (
        process_local_devices() if local_devices is None else local_devices)]
    if not local:
        raise ValueError("a rank brings at least one device to the mesh")
    if not dist.is_initialized():
        return Mesh(local, (axis_name,))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in local])
    devices = [d for devs in every for d in devs]
    ranks = [r for r, devs in enumerate(every) for _ in devs]
    return Mesh(devices, (axis_name,), ranks=ranks)
