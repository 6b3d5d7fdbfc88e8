#!/usr/bin/env python
"""Benchmark: 2ACE A2 solver throughput on one GPU.

Prints ONE JSON line:
  {"metric": "admm_iters_per_s", "value": N, "unit": "iter/s",
   "vs_baseline": N, ...extra keys...}

THE HEADLINE NUMBER TIMES THE FULL PRODUCTION SOLVER — ``value`` is
ADMM iterations per second measured through
``solve_lowrank_multi_pair_batch``: the complete ``inferLowRankV4_multi``
scaffold with spectral initialization, 3 restarts, held-out quality gates,
rank-1 fallback, column orthonormalization, per-column refinement,
full-data refinement with similarity rollback, per-iteration residual
convergence tests and *conditional* mu adaptation
(ref: inferLowRankV4_multi.m:5-109,363-382).  Iteration counts are the
while-loop trip counts actually consumed (PairAdmmResult.iters); under
vmap both branches of the rank-1 cond execute physically, so the reported
rate is conservative (hardware did at least this much work per second).

The solver runs at cfg.matmul_precision = "float32" (the production
default, HIGHEST: FP32 products), so the residual convergence tests fire
and the headline iter/s counts useful iterations (apples-to-apples with
the float64 MATLAB baseline's iterations).

Extra keys:
  recoveries_per_s   end-to-end 16x16 recoveries per second (the number
                     to compare against MATLAB's <~1 s per recovery,
                     reference README.md:87)
  kernel_iters_per_s the stripped fused-iteration loop (no residual tests,
                     unconditional mu ramp, backend-default matmul
                     precision) — an upper bound isolating per-iteration
                     compute cost; NOT production throughput
  solve_latency_ms   one single-recovery solve, host clock around a call
                     that ends in ``block_until_ready``
  median_nmse_db     recovery accuracy of the timed workload (sanity: the
                     speed is for solves that actually work)
  device, gpu        what ran it: JAX's platform/kind/count and the card's
                     ``nvidia-smi`` name and power limit

Workload: 16x16 CSI (n = 256), m = 1024 probes, over-parameterization
r = 20, BATCH independent 2-path channels measured through ONE shared
2-bit random codebook — the testbed's production setting, where every
repeat/restart measures through the same flashed .brd codebook
(ref: main/main.py:426-440).

Implementation notes (see twoace/ops/cplx.py):
  - complex matrices are carried as (re, im) float32 pairs; every matmul is
    a 3M-Karatsuba set of three real GEMMs
  - TRANSPOSED state layout: the over-parameterization axis r=20 leads, and
    with the codebook shared, XLA folds (batch, r) into one tall matmul row
    dimension
  - the Z-prox eigenbasis is carried across iterations and refined by a
    first-order perturbative update (skew correction + Newton-Schulz,
    ~5 small matmuls) instead of re-running a full eigendecomposition
  - every timed call ends in ``jax.block_until_ready``

Baseline: MATLAB solves a 16x16 recovery in < ~1 s (README.md:87) at an
iteration budget of up to ~4000 ADMM iterations per (M, method) cell
(SURVEY §3.2), i.e. roughly 4000 iterations/s on a laptop CPU.

The compile cache is JAX_COMPILATION_CACHE_DIR when set, else
<checkout>/.jax_cache (set by importing the package).
"""

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

import twoace  # noqa: F401  (places the persistent compile cache)

MATLAB_BASELINE_ITERS_PER_S = 4000.0

NT = NR = 16
N = NT * NR
M = 4 * N
R = 20
BATCH = 256         # kernel loop: independent recoveries, one codebook
ITERS = 100         # kernel loop: scanned ADMM iterations per timed call
SOLVE_BATCH = int(os.environ.get("TWOACE_BENCH_SOLVE_BATCH", 64))
MAXITER = 500       # reference iteration budget (inferLowRankV4_multi.m:13)
# Mixed-precision warm phase (config.AdmmConfig.warm_iters): the first 80
# iterations of each first-pass solve at the backend-default matmul
# precision.  A bench knob, not the library default (ROADMAP C3); its
# value on this card is ROADMAP A2/A7.  Off (0) via env for pure-f32 runs.
WARM_ITERS = int(os.environ.get("TWOACE_BENCH_WARM_ITERS", 80))
# Pass-1 iteration cap (config.AdmmConfig.stage1_maxiter): pass 2
# re-converges from the orthonormalized pass-1 state, so capping pass 1
# trades its tail for batch throughput.  A bench knob (ROADMAP C3/A7).
# 0 disables.
STAGE1_MAXITER = int(os.environ.get("TWOACE_BENCH_STAGE1_MAXITER", 120))
# Pass-2 iteration cap (config.AdmmConfig.stage2_maxiter): bounds the
# vmapped-lockstep straggler of the per-column pass; the full-data
# refinement stage re-converges the selected restart at full maxiter.
# A bench knob (ROADMAP C3/A7).  0 disables.
STAGE2_MAXITER = int(os.environ.get("TWOACE_BENCH_STAGE2_MAXITER", 160))


def build_problem(seed: int = 0):
    """Kernel-loop problem data in pair representation (numpy host-side)."""
    from twoace.ops.prox import profile_ladder
    from twoace.ops.cplx import Pair

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)        # shared codebook
    x_true = (rng.normal(size=(BATCH, N))
              + 1j * rng.normal(size=(BATCH, N))) / np.sqrt(2)
    b = np.abs(np.einsum("mn,un->um", a, x_true))
    u_mat = np.linalg.inv(a.conj().T @ a + np.eye(N))
    ladder = profile_ladder(NT, NR, M, N, False)

    def pair(x):
        return Pair(jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32))

    return (pair(a), jnp.asarray(b, jnp.float32), pair(u_mat), ladder)


def build_solve_problem(seed: int = 1):
    """Full-solve workload: SOLVE_BATCH sparse 2-path channels through one
    shared codebook (the production testbed shape)."""
    from twoace.ops.cplx import Pair

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    xs, bs = [], []
    for _ in range(SOLVE_BATCH):
        angs = rng.uniform(-1.2, 1.2, 4)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(NR, angs[2 * i]),
                           steer(NT, angs[2 * i + 1]).conj())
                for i in range(2))
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    ap = Pair(jnp.asarray(a.real, jnp.float32),
              jnp.asarray(a.imag, jnp.float32))
    return ap, jnp.asarray(np.stack(bs), jnp.float32), np.stack(xs)


def make_step(a, u_mat, ladder):
    from twoace.ops.cplx import admm_iteration_pair_t

    def run(b, state):
        step = admm_iteration_pair_t(a, b, u_mat, NT, NR, ladder,
                                     eig_mode="perturb")

        def body(s, _):
            return step(s), None

        state, _ = jax.lax.scan(body, state, None, length=ITERS)
        return state

    # codebook shared across the batch: XLA folds (batch, r) into the
    # matmul streaming dimension
    vrun = jax.vmap(run, in_axes=(0, 0))

    def run_and_reduce(b, state):
        out = vrun(b, state)
        y = out[0]
        return jnp.sum(y.re[:, 0, 0]) + jnp.sum(y.im[:, 0, 0])

    return jax.jit(run_and_reduce)


def bench_kernel_loop():
    """Stripped fused-iteration loop: per-iteration compute upper bound."""
    from twoace.ops.cplx import Pair, matmul, panel_gram_basis_pair

    a, b, u_mat, ladder = build_problem()
    ones = Pair(jnp.ones((BATCH, R, N), jnp.float32),
                jnp.zeros((BATCH, R, N), jnp.float32))
    a_t = Pair(a.re.T, a.im.T)
    y0 = jax.vmap(lambda p: matmul(p, a_t))(ones)

    def seed_basis(z):
        e = Pair(z.re.reshape(R, NT, NR).transpose(2, 0, 1).reshape(NR, R * NT),
                 z.im.reshape(R, NT, NR).transpose(2, 0, 1).reshape(NR, R * NT))
        return panel_gram_basis_pair(e)[1]

    basis0 = jax.vmap(seed_basis)(ones)
    state = (y0, ones,
             Pair(jnp.zeros((BATCH, R, M), jnp.float32),
                  jnp.zeros((BATCH, R, M), jnp.float32)),
             Pair(jnp.zeros((BATCH, R, N), jnp.float32),
                  jnp.zeros((BATCH, R, N), jnp.float32)),
             jnp.full((BATCH,), 1e-3, jnp.float32),
             basis0)
    step = make_step(a, u_mat, ladder)

    jax.block_until_ready(step(b, state))        # compile + warmup
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(step(b, state))
    dt = (time.perf_counter() - t0) / reps
    return BATCH * ITERS / dt


def bench_full_solve():
    """The production solver end to end; returns (iters/s, recov/s, nmse)."""
    from twoace.config import AdmmConfig
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch

    ap, b, x_true = build_solve_problem()
    cfg = AdmmConfig(maxiter=MAXITER, warm_iters=WARM_ITERS,
                     stage1_maxiter=STAGE1_MAXITER or None,
                     stage2_maxiter=STAGE2_MAXITER or None)
    key = jax.random.PRNGKey(0)

    t_c = time.perf_counter()
    res = jax.block_until_ready(
        solve_lowrank_multi_pair_batch(key, ap, b, NT, NR, cfg))
    first_call_s = time.perf_counter() - t_c   # ~compile cost (cold cache)

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        res = jax.block_until_ready(
            solve_lowrank_multi_pair_batch(key, ap, b, NT, NR, cfg))
    dt = (time.perf_counter() - t0) / reps
    total_iters = int(np.sum(np.asarray(res.iters)))

    x_est = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
    nmse = []
    for u in range(SOLVE_BATCH):
        c = np.vdot(x_est[u], x_true[u]) / max(
            np.vdot(x_est[u], x_est[u]).real, 1e-30)
        nmse.append(10 * np.log10(max(
            np.linalg.norm(x_true[u] - c * x_est[u]) ** 2
            / np.linalg.norm(x_true[u]) ** 2, 1e-30)))
    return (total_iters / dt, SOLVE_BATCH / dt, float(np.median(nmse)),
            first_call_s)


def bench_single_latency(reps: int = 10):
    """One-recovery latency in ms (the mobility-tracking path, ref:
    RSS_Mobility.m:155-188 re-solves per window): host clock around
    ``reps`` solves, each ending in ``block_until_ready``."""
    from twoace.config import AdmmConfig
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair

    rng = np.random.default_rng(3)
    bits = rng.integers(0, 4, (M, N))
    a = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(N)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)) / np.sqrt(2)
    ap = Pair(jnp.asarray(a.real, jnp.float32),
              jnp.asarray(a.imag, jnp.float32))
    b = jnp.asarray(np.abs(a @ x), jnp.float32)
    # COLD config: the warm-80 schedule is a batch-throughput knob, and its
    # two-phase graph is a second compile on the single-recovery path
    cfg = AdmmConfig(maxiter=MAXITER)
    key = jax.random.PRNGKey(0)
    jax.block_until_ready(solve_lowrank_multi_pair(key, ap, b, NT, NR, cfg))
    t0 = time.perf_counter()
    for i in range(reps):
        jax.block_until_ready(solve_lowrank_multi_pair(
            jax.random.fold_in(key, i), ap, b, NT, NR, cfg))
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    from twoace.config import AdmmConfig
    from twoace.utils.device import describe_devices, require_gpu

    require_gpu()
    full_iters_per_s, recov_per_s, med_nmse, first_call_s = bench_full_solve()
    kernel_iters_per_s = bench_kernel_loop()
    latency_ms = bench_single_latency()

    print(json.dumps({
        "metric": "admm_iters_per_s",
        "value": round(full_iters_per_s, 1),
        "unit": "iter/s",
        "vs_baseline": round(full_iters_per_s / MATLAB_BASELINE_ITERS_PER_S,
                             2),
        "recoveries_per_s": round(recov_per_s, 2),
        "kernel_iters_per_s": round(kernel_iters_per_s, 1),
        "solve_latency_ms": round(latency_ms, 1),
        "median_nmse_db": round(med_nmse, 1),
        "solve_batch": SOLVE_BATCH,
        "maxiter": MAXITER,
        "matmul_precision": AdmmConfig().matmul_precision,
        "warm_iters": WARM_ITERS,
        "stage1_maxiter": STAGE1_MAXITER,
        "stage2_maxiter": STAGE2_MAXITER,
        # first solve_lowrank_multi_pair_batch call incl. trace+compile of
        # the three staged jits (near-zero when .jax_cache is warm)
        "first_call_s": round(first_call_s, 1),
        **describe_devices(),
    }))


if __name__ == "__main__":
    main()
