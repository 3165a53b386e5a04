"""Meshes of torch devices: chain and spatial parallelism, in one process
or across the ranks of ``torch.distributed`` (``multihost``)."""

from .mesh import Mesh, Slots, make_mesh, shard_chains
from .multihost import global_mesh, initialize, process_local_devices

__all__ = ["Mesh", "Slots", "make_mesh", "shard_chains", "global_mesh",
           "initialize", "process_local_devices"]
