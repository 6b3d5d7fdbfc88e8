#!/usr/bin/env python
"""Lockstep-waste accounting for the staged batch solver.

A vmapped ``lax.while_loop`` runs every lane until the slowest lane's trip
count (converged lanes burn full-cost masked iterations), so the EXECUTED
iteration count of each staged solve is ``n_lanes * max(trips)`` while the
USEFUL count is ``sum(trips)``.  This script runs ``_batch_first_pass``
(the 6-of-8 solves of the production scaffold) on the bench workload and
reports the per-solve trip-count distribution and the implied waste —
the count that decides whether the pass caps pay (ROADMAP A7).

Prints one JSON line.  Run on a GPU:
    python scripts/bench_lockstep.py [batch] [cap1] [cap2] [warm]
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import twoace  # noqa: F401,E402  (places the persistent compile cache)


def main():
    from twoace.config import AdmmConfig
    from twoace.ops import pair_solver as ps
    from twoace.ops.prox import profile_ladder_arrays
    from twoace.utils.device import describe_devices, require_gpu

    require_gpu()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    os.environ["TWOACE_BENCH_SOLVE_BATCH"] = str(batch)
    bench.SOLVE_BATCH = batch
    a, b_batch, _ = bench.build_solve_problem()
    nt = nr = 16
    m, n = a.shape
    cap = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    cap2 = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    warm = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    cfg = AdmmConfig(maxiter=bench.MAXITER,
                     stage1_maxiter=cap or None,
                     stage2_maxiter=cap2 or None,
                     warm_iters=warm)
    pl = cfg.profile

    key = jax.random.PRNGKey(0)
    n_restarts = cfg.n_restarts
    keys = jax.random.split(jax.random.fold_in(key, 7), batch)
    k_inits = jax.vmap(lambda ki: jnp.stack(
        [jax.random.split(jax.random.fold_in(ki, i))[1]
         for i in range(n_restarts)]))(keys)
    splits = tuple(
        ps._split(jax.random.split(jax.random.fold_in(key, i))[0], m,
                  cfg.cc_frac)
        for i in range(n_restarts))
    trains = jnp.stack([t for t, _ in splits])
    tests = jnp.stack([t for _, t in splits])
    lm_tr = int(math.floor(m * cfg.cc_frac))
    lad_tr = profile_ladder_arrays(nt, nr, lm_tr, n, False, pl.rank_mults,
                                   pl.fractions, mode=pl.ladder)

    with jax.default_matmul_precision(cfg.matmul_precision):
        _, q, it, _, _, _, _, _ = ps._batch_first_pass(
            k_inits, a, b_batch, trains, tests, lad_tr, nt=nt, nr=nr,
            cfg=cfg, prox_kind="spectral_profile", eig_mode="perturb",
            m_eff=m)
    it = np.asarray(it)              # (B, R, 2): per-lane trips per solve
    q = np.asarray(q)

    def acct(t):
        t = t.reshape(-1).astype(float)
        return {
            "mean": round(float(t.mean()), 1),
            "p50": round(float(np.median(t)), 1),
            "p90": round(float(np.percentile(t, 90)), 1),
            "max": int(t.max()),
            # lockstep executes n_lanes * max; waste = 1 - sum/ (n*max)
            "lockstep_waste": round(1.0 - t.sum() / (t.size * t.max()), 3),
        }

    out = {
        "workload": {"batch": batch, "m": m, "n": n,
                     "maxiter": cfg.maxiter, "restarts": n_restarts,
                     "stage1_maxiter": cfg.stage1_maxiter,
                     "stage2_maxiter": cfg.stage2_maxiter,
                     "warm_iters": cfg.warm_iters,
                     "matmul_precision": cfg.matmul_precision},
        **describe_devices(),
        "solve1_scale_by_row": acct(it[..., 0]),
        "solve2_per_column": acct(it[..., 1]),
        "combined_first_pass": {
            "useful_iters": int(it.sum()),
            "executed_iters": int(it.shape[0] * it.shape[1]
                                  * (it[..., 0].max() + it[..., 1].max())),
            "waste": round(1.0 - it.sum()
                           / (it.shape[0] * it.shape[1]
                              * (it[..., 0].max() + it[..., 1].max())), 3),
        },
        "poor_quality_lanes": int((q < cfg.quality_threshold).sum()),
        "note": "first-pass stage only (6 of ~8 solves of the scaffold); "
                "lockstep executed = lanes * max(trips) per vmapped "
                "while_loop.  waste is the fraction of executed iterations "
                "spent on already-converged lanes.",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
