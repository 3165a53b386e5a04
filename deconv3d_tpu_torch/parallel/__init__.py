"""Meshes of torch devices: chain and spatial parallelism in one process."""

from .mesh import Mesh, make_mesh, shard_chains

__all__ = ["Mesh", "make_mesh", "shard_chains"]
