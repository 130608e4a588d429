"""Multi-host execution helpers.

Replaces the reference's MPI layer (`mpi4py`, ``nifty/cl/utilities.py``)
for pod-scale runs: initialize `jax.distributed`, build global meshes
whose sample axis spans hosts (samples cross hosts, field axes stay within one),
and provide the host-local slicing helpers that `shareRange` provided
under MPI.  Reductions need no special determinism handling — mesh
collectives have a fixed reduction tree, so results are bitwise
identical for any host count (the property cl's `allreduce_sum`
hand-rolled).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "initialize",
    "global_mesh",
    "host_local_slice",
    "process_count",
    "process_index",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize multi-host jax (no-op on a single host).  With no
    arguments, relies on the cluster environment to set everything."""
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def global_mesh(
    axis_names: Sequence[str] = ("samples",),
    axis_sizes: Optional[Sequence[int]] = None,
    *,
    devices=None,
) -> Mesh:
    """A mesh over all global devices.

    With one axis, all devices line up on it (samples over hosts).  With
    several, `axis_sizes` splits the device count; by default the first
    axis gets `process_count()` (data/sample parallel across hosts) and
    the remaining axes factor the local device count (field axes).
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    n = devices.size
    if axis_sizes is None:
        if len(axis_names) == 1:
            axis_sizes = (n,)
        else:
            first = jax.process_count()
            rest = n // first
            sizes = [first]
            remaining = rest
            for _ in axis_names[1:-1]:
                sizes.append(1)
            sizes.append(remaining)
            axis_sizes = tuple(sizes)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(
            f"axis sizes {axis_sizes} do not factor device count {n}"
        )
    return Mesh(devices.reshape(axis_sizes), tuple(axis_names))


def host_local_slice(n_items: int, *, count=None, index=None) -> Tuple[int, int]:
    """Contiguous [lo, hi) range of `n_items` owned by this process —
    the jax-native `shareRange` (reference: ``nifty/cl/utilities.py:282``)."""
    count = jax.process_count() if count is None else count
    index = jax.process_index() if index is None else index
    base, extra = divmod(n_items, count)
    lo = index * base + min(index, extra)
    hi = lo + base + (1 if index < extra else 0)
    return lo, hi
