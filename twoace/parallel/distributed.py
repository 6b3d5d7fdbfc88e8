"""Multi-host initialization.

The reference scales by adding MATLAB parfor workers on one machine
(ref: Vs_M_par.m:145); here per-host processes join with
``jax.distributed.initialize`` into a global (batch x rows) mesh over all
devices, batch sharded across hosts and rows within a host.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join a multi-host run.  No-op when running single-process.

    Pass all three arguments: nothing on a plain GPU host tells JAX of a
    cluster (e.g. ``coordinator="localhost:12355"`` on one machine).
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
