"""Device-mesh helpers.

The reference's only parallelism is a MATLAB ``parfor`` process pool over
Monte-Carlo channel instances (ref: Numerical_Simulation/main_programs/
Vs_M_par.m:145) and a multiprocessing pool for RSS dumps
(ref: main/codebook_library.py:538-548).  The replacement
(SURVEY §2.8) is a 2-D device mesh:

  - ``batch`` axis: independent problem instances (data parallelism — the
    parfor replacement), gradient-free so no collectives beyond none.
  - ``rows`` axis: measurement-row sharding *within* one solve — the
    ``A^H (...)`` reductions and residual norms become ``psum`` across
    devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BATCH_AXIS = "batch"
ROWS_AXIS = "rows"


def make_mesh(batch: Optional[int] = None, rows: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a (batch x rows) mesh over the available devices.

    ``batch=None`` uses all remaining devices after the rows axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if batch is None:
        if n % rows != 0:
            raise ValueError(f"{n} devices not divisible by rows={rows}")
        batch = n // rows
    if batch * rows != n:
        devices = devices[: batch * rows]
    arr = np.asarray(devices).reshape(batch, rows)
    return Mesh(arr, (BATCH_AXIS, ROWS_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 over the batch axis, replicate the rest."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def problem_sharding(mesh: Mesh) -> Tuple[NamedSharding, NamedSharding]:
    """Shardings for (A, B): batch on axis 0, measurement rows on axis 1."""
    return (NamedSharding(mesh, P(BATCH_AXIS, ROWS_AXIS, None)),
            NamedSharding(mesh, P(BATCH_AXIS, ROWS_AXIS)))
