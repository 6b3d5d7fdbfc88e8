#!/usr/bin/env python
"""Trip-count distribution of the full-data refinement stage (stage 3).

Besides the two first-pass solves (see bench_lockstep.py), the remaining
vmapped while_loop on the batch path is `_batch_refine` — one full-data
solve per instance from the selected restart's (already converged)
iterate.  This script reproduces
the staged pipeline up to stage 3 with zeroed iteration carry, so
``res.iters`` IS the per-instance refine trip count, and reports the
distribution + implied lockstep waste of the refine stage alone.

Prints one JSON line.  Run on a GPU:
    python scripts/bench_refine_trips.py [batch] [warm]
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

    import bench

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    warm = int(sys.argv[2]) if len(sys.argv) > 2 else 80
    os.environ["TWOACE_BENCH_SOLVE_BATCH"] = str(batch)
    bench.SOLVE_BATCH = batch
    a, b_batch, _ = bench.build_solve_problem()
    nt = nr = 16
    m, n = a.shape
    cfg = AdmmConfig(maxiter=bench.MAXITER, warm_iters=warm,
                     stage1_maxiter=120, stage2_maxiter=160)
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
    lad_full = profile_ladder_arrays(nt, nr, m, n, False, pl.rank_mults,
                                     pl.fractions, mode=pl.ladder)
    lad_full_r1 = profile_ladder_arrays(nt, nr, m, n, True, pl.rank_mults,
                                        pl.fractions, mode=pl.ladder)

    with jax.default_matmul_precision(cfg.matmul_precision):
        x, q, it, _, a_n, b_n, a_norm, b_norm = ps._batch_first_pass(
            k_inits, a, b_batch, trains, tests, lad_tr, nt=nt, nr=nr,
            cfg=cfg, prox_kind="spectral_profile", eig_mode="perturb",
            m_eff=m)
        # zeroed carry => res.iters is exactly the refine trip count
        res = ps._batch_refine(
            a_n, b_n, x, q, jnp.zeros((batch,), jnp.int32),
            jnp.zeros((batch, n_restarts), bool), lad_full, lad_full_r1,
            a_norm, b_norm, nt=nt, nr=nr, cfg=cfg,
            prox_kind="spectral_profile", eig_mode="perturb")
    t = np.asarray(res.iters).astype(float)

    out = {
        "workload": {"batch": batch, "m": m, "n": n,
                     "maxiter": cfg.maxiter, "restarts": n_restarts,
                     "stage1_maxiter": cfg.stage1_maxiter,
                     "stage2_maxiter": cfg.stage2_maxiter,
                     "warm_iters": warm,
                     "matmul_precision": cfg.matmul_precision},
        **describe_devices(),
        "refine_trips": {
            "mean": round(float(t.mean()), 1),
            "p50": round(float(np.median(t)), 1),
            "p90": round(float(np.percentile(t, 90)), 1),
            "max": int(t.max()),
            "lockstep_waste": round(1.0 - t.sum() / (t.size * t.max()), 3),
        },
        "note": "refine stage only (1 of ~8 solves, full-data, warm "
                "phase excluded by design so trips are f32-tail only); "
                "lockstep executed = batch * max(trips).",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
