"""Device-mesh utilities for sample/chain/field parallelism.

The framework's primary parallel axis is the VI *sample* axis (and the
MCMC *chain* axis): posterior samples are independent apart from
mean-reductions in the KL, so they shard perfectly over devices with a single
``psum`` per KL evaluation.  These helpers build the 1-D (or N-D, for
future field-axis sharding) meshes and shardings used by
``optimize_kl``/HMC.

Replaces the reference's MPI layer (``nifty/cl/utilities.py:282-420``)
with ``jax.sharding`` collectives; the deterministic-reduction requirement
is automatically met because mesh reductions have a fixed tree shape.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["sample_mesh", "sample_sharding", "replicated_sharding"]


def sample_mesh(devices: Optional[Sequence] = None, axis_name: str = "samples") -> Mesh:
    """A 1-D mesh over `devices` (default: all local devices)."""
    devices = jax.devices() if devices is None else list(devices)
    return Mesh(np.asarray(devices), (axis_name,))


def sample_sharding(mesh: Mesh, axis_name: str = "samples") -> NamedSharding:
    """Shard the leading (sample) axis over the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully-replicated placement on the mesh."""
    return NamedSharding(mesh, PartitionSpec())
