#!/usr/bin/env python
"""Full-solve benchmark: complete 2ACE A2 recoveries on one GPU.

Times `solve_lowrank_multi_pair_batch` — the ENTIRE inferLowRankV4_multi
scaffold (spectral init, 3 restarts with train/test quality gates, rank-1
fallback, orthonormalization, per-column refinement, full-data refinement
with rollback) — for a batch of 16x16 recoveries through one shared
codebook, at the reference's production probe budget (m = 1024 = 4n) and
iteration budget (maxiter 500).

Reference point: MATLAB solves ONE such recovery in < ~1 s on a laptop CPU
(reference README.md:87).

Shape knobs: NT, NR, M, BATCH, MAXITER, WARM, S1CAP, S2CAP (environment).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

import twoace  # noqa: F401,E402  (places the persistent compile cache)

NT = int(os.environ.get("NT", 16))
NR = int(os.environ.get("NR", NT))
N = NT * NR
M = int(os.environ.get("M", 4 * N))
BATCH = int(os.environ.get("BATCH", 64))
MAXITER = int(os.environ.get("MAXITER", 500))
WARM = int(os.environ.get("WARM", 0))
S1CAP = int(os.environ.get("S1CAP", 0))    # 0 = uncapped
S2CAP = int(os.environ.get("S2CAP", 0))    # 0 = uncapped


def main():
    from twoace.config import AdmmConfig
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch
    from twoace.utils.device import describe_devices, require_gpu

    require_gpu()
    print(describe_devices())
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    xs, bs = [], []
    for u in range(BATCH):
        angs = rng.uniform(-1.2, 1.2, 4)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(NR, angs[2 * i]), steer(NT, angs[2 * i + 1]).conj())
                for i in range(2))
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    x_true = np.stack(xs)
    b = jnp.asarray(np.stack(bs), jnp.float32)
    ap = Pair(jnp.asarray(a.real, jnp.float32), jnp.asarray(a.imag, jnp.float32))

    cfg = AdmmConfig(maxiter=MAXITER, warm_iters=WARM,
                     stage1_maxiter=S1CAP or None,
                     stage2_maxiter=S2CAP or None)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    res = jax.block_until_ready(
        solve_lowrank_multi_pair_batch(key, ap, b, NT, NR, cfg))
    q0 = float(jnp.min(res.quality))
    t_compile_and_run = time.perf_counter() - t0

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = jax.block_until_ready(
            solve_lowrank_multi_pair_batch(key, ap, b, NT, NR, cfg))
    dt = (time.perf_counter() - t0) / reps

    x_est = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
    nmse = []
    for u in range(BATCH):
        c = np.vdot(x_est[u], x_true[u]) / max(
            np.vdot(x_est[u], x_est[u]).real, 1e-30)
        nmse.append(10 * np.log10(max(
            np.linalg.norm(x_true[u] - c * x_est[u]) ** 2
            / np.linalg.norm(x_true[u]) ** 2, 1e-30)))

    print(f"first call (compile+run): {t_compile_and_run:.1f} s  "
          f"(min quality {q0:.4f})")
    print(f"steady state: {BATCH / dt:,.1f} full {NT}x{NR} recoveries/s "
          f"({dt * 1e3:.0f} ms for batch of {BATCH}; maxiter={MAXITER})")
    print(f"vs MATLAB (<~1 s/recovery): {BATCH / dt:,.0f}x")
    print(f"recovery NMSE: median {np.median(nmse):.1f} dB, "
          f"worst {np.max(nmse):.1f} dB, min quality "
          f"{float(jnp.min(res.quality)):.4f}")


if __name__ == "__main__":
    main()
