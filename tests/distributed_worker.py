"""Worker process for the multi-host jax.distributed test.

Launched by tests/test_distributed.py as N separate OS processes, each
with its own virtual CPU device count, joined through
``twoace.parallel.distributed.initialize_multihost``.  This validates
the actual multi-host code path (coordinator handshake, global mesh over
non-addressable devices, cross-process collectives) that a multi-host
deployment would use — the reference's analog is the parfor pool of
``Vs_M_par.m:145``, which has no cross-worker communication at all.

Each process:
  1. joins the cluster (jax.distributed.initialize via initialize_multihost)
  2. asserts the global device count is num_processes * local_devices
  3. builds the global (batch x rows) mesh from twoace.parallel.mesh
  4. assembles a globally-sharded batch of tiny phase-retrieval problems
     with jax.make_array_from_process_local_data (each process contributes
     its local batch shard)
  5. runs the production sharded solver one step and a cross-process psum
  6. process 0 prints "DISTRIBUTED_OK <global_batch> <nmse_db>"

Not collected by pytest (no test_ prefix).
"""

import os
import sys

DEVICES_PER_PROC = 2


def main() -> None:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    port = int(sys.argv[3])

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEVICES_PER_PROC}"
    ).strip()

    import numpy as np
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from twoace.config import AdmmConfig
    from twoace.parallel.distributed import initialize_multihost
    from twoace.parallel.mesh import make_mesh, problem_sharding
    from twoace.parallel.sharded_admm import solve_lowrank_sharded

    initialize_multihost(coordinator=f"127.0.0.1:{port}",
                         num_processes=num_processes,
                         process_id=process_id)

    assert jax.process_index() == process_id
    assert jax.process_count() == num_processes
    n_global = len(jax.devices())
    assert n_global == num_processes * DEVICES_PER_PROC, (
        f"expected {num_processes * DEVICES_PER_PROC} global devices, "
        f"got {n_global}")

    # Global mesh: batch axis spans all devices across both processes.
    mesh = make_mesh(batch=n_global, rows=1)
    a_sh, b_sh = problem_sharding(mesh)

    # Tiny problem: 4x4 CSI, 64 probes, one instance per global device.
    nt = nr = 4
    n = nt * nr
    m = 64
    batch = n_global

    # Deterministic global data; every process computes the same full
    # arrays and contributes its local shard.
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 4, size=(batch, m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    x_true = (rng.standard_normal((batch, n))
              + 1j * rng.standard_normal((batch, n))).astype(np.complex64)
    b = np.abs(np.einsum("umn,un->um", a, x_true)).astype(np.float32)

    per_proc = batch // num_processes
    lo = process_id * per_proc
    hi = lo + per_proc
    a_g = jax.make_array_from_process_local_data(a_sh, a[lo:hi])
    b_g = jax.make_array_from_process_local_data(b_sh, b[lo:hi])

    cfg = AdmmConfig(maxiter=30)
    x = solve_lowrank_sharded(mesh, a_g, b_g, nt, nr, cfg)

    # Cross-process reduction: global phase-aligned NMSE over the whole
    # batch, computed with a jitted global-array contraction (requires
    # collectives across the two processes).
    x_true_g = jax.make_array_from_process_local_data(
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("batch")),
        x_true[lo:hi])

    @jax.jit
    def nmse_db(xh, xt):
        inner = jnp.sum(jnp.conj(xh) * xt, axis=1)
        scale = inner / jnp.maximum(
            jnp.sum(jnp.abs(xh) ** 2, axis=1), 1e-30)
        err = jnp.sum(jnp.abs(xt - scale[:, None] * xh) ** 2, axis=1)
        ref = jnp.sum(jnp.abs(xt) ** 2, axis=1)
        return 10.0 * jnp.log10(jnp.mean(err / ref))

    val = float(jax.device_get(nmse_db(x, x_true_g)))
    assert np.isfinite(val), f"non-finite NMSE {val}"

    if process_id == 0:
        print(f"DISTRIBUTED_OK {batch} {val:.3f}", flush=True)

    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
