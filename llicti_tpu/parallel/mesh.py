"""Device-mesh helpers for SPMD training/inference.

The reference has no distributed support (SURVEY.md §2.3); here
parallelism is first-class, expressed as GSPMD shardings:

* ``data`` axis: data-parallel training — batch sharded, params
  replicated; XLA inserts the psum gradient reduction.
* ``spatial`` axis: large-image spatial sharding — H sharded; XLA
  inserts halo exchanges (collective-permute) for the small layer-0
  convs automatically under GSPMD.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        data = n // spatial
    assert data * spatial <= n, (data, spatial, n)
    devs = np.array(devices[: data * spatial]).reshape(data, spatial)
    return Mesh(devs, axis_names=("data", "spatial"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, has_acc_axis: bool = False) -> NamedSharding:
    """Sharding for [*(acc), B, H, W, C] batches: B over data, H over spatial."""
    if has_acc_axis:
        return NamedSharding(mesh, P(None, "data", "spatial", None, None))
    return NamedSharding(mesh, P("data", "spatial", None, None))
