"""The pair-representation full A2 solver (the production path) must match the
complex-dtype solver end-to-end — same scaffold, same recoveries."""

import numpy as np
import jax
import jax.numpy as jnp

from twoace.config import AdmmConfig
from twoace.ops.cplx import Pair
from twoace.ops.admm import solve_lowrank_multi
from twoace.ops.pair_solver import (
    infer_admm_pair,
    magnitude_prox_cols_elem,
    precompute_u_pair,
    project_cols_to_magnitude,
    solve_lowrank_multi_pair,
    spectral_initialize_pair,
)


def _steer(nn, ang):
    return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)


def _problem(nt=8, nr=8, m_mult=4, seed=0, noise=0.0):
    n = nt * nr
    m = m_mult * n
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    h = sum((rng.normal() + 1j * rng.normal())
            * np.outer(_steer(nr, a1), _steer(nt, a2).conj())
            for a1, a2 in [(0.3, -0.5), (0.9, 0.2)])
    x_true = h.T.reshape(-1)
    b = np.abs(a @ x_true)
    if noise:
        b = b + noise * rng.normal(size=m) * b.mean()
        b = np.maximum(b, 0.0)
    return a, b.astype(np.float32), x_true


def _nmse_db(x_est, x_gt):
    x_est = np.asarray(x_est)
    c = np.vdot(x_est, x_gt) / max(np.vdot(x_est, x_est).real, 1e-30)
    err = (np.linalg.norm(x_gt - c * x_est) ** 2
           / np.linalg.norm(x_gt) ** 2)
    return 10 * np.log10(max(err, 1e-30))


def _pair(x):
    return Pair(jnp.asarray(np.real(x), jnp.float32),
                jnp.asarray(np.imag(x), jnp.float32))


def test_precompute_u_pair_matches_inverse():
    a, _, _ = _problem(nt=4, nr=4)
    u = precompute_u_pair(_pair(a))
    u_ref = np.linalg.inv(a.conj().T @ a + np.eye(a.shape[1]))
    np.testing.assert_allclose(np.asarray(u.re), u_ref.real, atol=2e-5)
    np.testing.assert_allclose(np.asarray(u.im), u_ref.imag, atol=2e-5)


def test_spectral_initialize_pair_spans_reference_subspace():
    a, b, _ = _problem(nt=4, nr=4)
    r = 4
    x0t = spectral_initialize_pair(_pair(a), jnp.asarray(b), r,
                                   key=jax.random.PRNGKey(1))
    x0 = np.asarray(x0t.re).T + 1j * np.asarray(x0t.im).T     # (n, r)
    # reference: top-r eigvecs of the scaled Gram, scaled by sqrt(eigval)
    scale = b / np.linalg.norm(a, axis=1)
    a_s = a * scale[:, None]
    g = a_s.conj().T @ a_s
    w, v = np.linalg.eigh(g)
    w, v = w[::-1][:r], v[:, ::-1][:, :r]
    ref = v * np.sqrt(np.maximum(w, 0))[None, :]
    # same column magnitudes...
    np.testing.assert_allclose(np.linalg.norm(x0, axis=0),
                               np.linalg.norm(ref, axis=0), rtol=1e-3)
    # ...and same subspace: projection of ref onto span(x0) preserves norm
    q, _ = np.linalg.qr(x0)
    proj = q @ (q.conj().T @ ref)
    np.testing.assert_allclose(np.linalg.norm(proj), np.linalg.norm(ref),
                               rtol=1e-3)


def test_pair_proxes_match_complex():
    from twoace.ops.prox import magnitude_prox, project_rows_to_magnitude

    rng = np.random.default_rng(3)
    m, r = 24, 5
    y = (rng.normal(size=(m, r)) + 1j * rng.normal(size=(m, r))).astype(
        np.complex64)
    b = rng.uniform(0.5, 2.0, m).astype(np.float32)
    md = (rng.normal(size=(m, r)) + 1j * rng.normal(size=(m, r))).astype(
        np.complex64)
    mu = 0.4

    ref = np.asarray(magnitude_prox(jnp.asarray(y), jnp.asarray(b),
                                    jnp.asarray(md), mu, False))
    out = magnitude_prox_cols_elem(_pair(y.T), jnp.asarray(b), _pair(md.T), mu)
    np.testing.assert_allclose(np.asarray(out.re).T, ref.real, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.im).T, ref.imag, atol=1e-5)

    for sbr in (True, False):
        ref = np.asarray(project_rows_to_magnitude(jnp.asarray(y),
                                                   jnp.asarray(b), sbr))
        out = project_cols_to_magnitude(_pair(y.T), jnp.asarray(b), sbr)
        np.testing.assert_allclose(np.asarray(out.re).T, ref.real, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.im).T, ref.imag, atol=1e-5)


def test_full_pair_solver_matches_complex_solver():
    """End-to-end A2: both paths recover a 2-path 8x8 channel exactly."""
    a, b, x_true = _problem()
    cfg = AdmmConfig(maxiter=200)
    key = jax.random.PRNGKey(0)
    res_c = solve_lowrank_multi(key, jnp.asarray(a), jnp.asarray(b), 8, 8, cfg)
    res_p = solve_lowrank_multi_pair(key, _pair(a), jnp.asarray(b), 8, 8, cfg)
    x_p = np.asarray(res_p.x.re) + 1j * np.asarray(res_p.x.im)
    assert _nmse_db(np.asarray(res_c.x), x_true) < -40
    assert _nmse_db(x_p, x_true) < -40
    assert float(res_p.quality) > 0.99


def test_full_pair_solver_noisy_parity():
    """With measurement noise the two paths land within 1.5 dB NMSE."""
    a, b, x_true = _problem(seed=5, noise=0.05)
    cfg = AdmmConfig(maxiter=150)
    key = jax.random.PRNGKey(2)
    res_c = solve_lowrank_multi(key, jnp.asarray(a), jnp.asarray(b), 8, 8, cfg)
    res_p = solve_lowrank_multi_pair(key, _pair(a), jnp.asarray(b), 8, 8, cfg)
    x_p = np.asarray(res_p.x.re) + 1j * np.asarray(res_p.x.im)
    db_c = _nmse_db(np.asarray(res_c.x), x_true)
    db_p = _nmse_db(x_p, x_true)
    assert db_p < -8
    assert abs(db_p - db_c) < 1.5


def test_pair_solver_nuclear_variant_parity():
    """Nuclear prox variant: pair path tracks the complex path to <0.5 dB."""
    a, b, x_true = _problem(seed=1)
    cfg = AdmmConfig(maxiter=150, n_restarts=1)
    key = jax.random.PRNGKey(3)
    res_c = solve_lowrank_multi(key, jnp.asarray(a), jnp.asarray(b), 8, 8,
                                cfg, prox_kind="nuclear")
    res_p = solve_lowrank_multi_pair(key, _pair(a), jnp.asarray(b), 8, 8,
                                     cfg, prox_kind="nuclear")
    x = np.asarray(res_p.x.re) + 1j * np.asarray(res_p.x.im)
    # this seed converges poorly (quality ~0.6) so NMSE is noise-sensitive;
    # parity is judged loosely on NMSE and tightly on the quality score
    assert abs(_nmse_db(x, x_true) - _nmse_db(np.asarray(res_c.x), x_true)) \
        < 2.5
    assert abs(float(res_p.quality) - float(res_c.quality)) < 0.1


def test_infer_admm_pair_jacobi_mode_matches_perturb():
    """Both in-loop eig modes drive the same recovery."""
    a, b, x_true = _problem(seed=4)
    from twoace.ops.prox import profile_ladder

    m, n = a.shape
    ladder = profile_ladder(8, 8, m, n, False)
    xs = spectral_initialize_pair(_pair(a), jnp.asarray(b), 8,
                                  key=jax.random.PRNGKey(0))
    for mode in ("jacobi", "perturb"):
        x, y, _, it = infer_admm_pair(_pair(a), jnp.asarray(b), xs,
                                      scale_by_row=True, nt=8, nr=8,
                                      ladder=ladder, maxiter=150,
                                      eig_mode=mode)
        assert 0 < int(it) <= 150
        # collapse the over-parameterized solution to its top column via
        # the Gram's leading eigenvector direction: just check the fit
        ax_re = np.asarray(x.re) @ a.real.T.astype(np.float32) \
            - np.asarray(x.im) @ a.imag.T.astype(np.float32)
        ax_im = np.asarray(x.re) @ a.imag.T.astype(np.float32) \
            + np.asarray(x.im) @ a.real.T.astype(np.float32)
        amp = np.sqrt((ax_re ** 2 + ax_im ** 2).sum(axis=0))
        rel = np.linalg.norm(amp - b) / np.linalg.norm(b)
        assert rel < 0.05, mode


def test_batched_shared_codebook_solver():
    """solve_lowrank_multi_pair_batch: many channels, one codebook."""
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch

    nt = nr = 8
    n, m, batch = 64, 256, 2
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    xs, bs = [], []
    for u in range(batch):
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(_steer(nr, a1), _steer(nt, a2).conj())
                for a1, a2 in [(0.2 + 0.1 * u, -0.4), (0.8, 0.3 - 0.2 * u)])
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    b_batch = jnp.asarray(np.stack(bs), jnp.float32)
    res = solve_lowrank_multi_pair_batch(jax.random.PRNGKey(0), _pair(a),
                                         b_batch, nt, nr,
                                         AdmmConfig(maxiter=150))
    assert res.x.re.shape == (batch, n)
    # iteration accounting: >= 3 solves of <= 150 iters each ran per instance
    assert res.iters.shape == (batch,)
    assert all(0 < int(v) <= 150 * 8 for v in res.iters)
    for u in range(batch):
        x_est = np.asarray(res.x.re[u]) + 1j * np.asarray(res.x.im[u])
        assert _nmse_db(x_est, xs[u]) < -35, u
        assert float(res.quality[u]) > 0.98


def test_batched_solver_pass_caps_preserve_recovery():
    """stage1_maxiter / stage2_maxiter (config.AdmmConfig): the pass-1 and
    pass-2 iteration caps bound the vmapped-lockstep stragglers
    (scripts/bench_lockstep.py) without degrading recovery — the full-data
    refinement stage still runs at full maxiter and re-converges the
    selected restart.  The capped run must (a) recover to the same
    accuracy class, (b) keep the held-out quality gate green, and
    (c) consume strictly fewer inner iterations than the uncapped run."""
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch

    nt = nr = 8
    n, m, batch = 64, 256, 2
    rng = np.random.default_rng(17)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    xs, bs = [], []
    for u in range(batch):
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(_steer(nr, a1), _steer(nt, a2).conj())
                for a1, a2 in [(0.25 + 0.1 * u, -0.45), (0.85, 0.35)])
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    b_batch = jnp.asarray(np.stack(bs), jnp.float32)
    key = jax.random.PRNGKey(3)
    res0 = solve_lowrank_multi_pair_batch(
        jax.random.PRNGKey(3), _pair(a), b_batch, nt, nr,
        AdmmConfig(maxiter=300))
    res = solve_lowrank_multi_pair_batch(
        key, _pair(a), b_batch, nt, nr,
        AdmmConfig(maxiter=300, stage1_maxiter=60, stage2_maxiter=80))
    for u in range(batch):
        x_est = np.asarray(res.x.re[u]) + 1j * np.asarray(res.x.im[u])
        assert _nmse_db(x_est, xs[u]) < -35, u
        assert float(res.quality[u]) > 0.98
        assert int(res.iters[u]) < int(res0.iters[u]), u


def test_batched_solver_host_gated_retry():
    """The staged rank-1 retry path (ops/pair_solver.py: gather poor
    (instance, restart) pairs on the host, bucket-pad, scatter back —
    ref semantics inferLowRankV4_multi.m:73-77).

    quality_threshold = 2.0 makes EVERY restart 'poor' (quality <= 1 by
    construction), forcing the retry for all batch x restart pairs — with
    batch = 3 and 2 restarts, k_n = 6 pads to the k_pad = 8 bucket, so the
    non-power-of-two padding path runs too.  Single-path channels are what
    the rank-1 fallback is FOR, so recovery must stay accurate, and the
    retry's iterations must be accounted into res.iters."""
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch

    nt = nr = 8
    n, m, batch = 64, 256, 3
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    xs, bs = [], []
    for u in range(batch):
        h = np.outer(_steer(nr, 0.1 + 0.2 * u), _steer(nt, -0.3).conj())
        x = h.T.reshape(-1)
        xs.append(x)
        bs.append(np.abs(a @ x))
    b_batch = jnp.asarray(np.stack(bs), jnp.float32)
    cfg = AdmmConfig(maxiter=120, n_restarts=2, quality_threshold=2.0)
    res = solve_lowrank_multi_pair_batch(jax.random.PRNGKey(2), _pair(a),
                                         b_batch, nt, nr, cfg)
    cfg0 = AdmmConfig(maxiter=120, n_restarts=2)
    res0 = solve_lowrank_multi_pair_batch(jax.random.PRNGKey(2), _pair(a),
                                          b_batch, nt, nr, cfg0)
    for u in range(batch):
        x_est = np.asarray(res.x.re[u]) + 1j * np.asarray(res.x.im[u])
        assert _nmse_db(x_est, xs[u]) < -35, u
        # retry adds two extra inner solves per (instance, restart):
        # strictly more iterations than the no-retry run
        assert int(res.iters[u]) > int(res0.iters[u]), u


def test_phaselift_bm_pair_matches_complex():
    """Pair-form Burer-Monteiro PhaseLift recovers like the complex one."""
    from twoace.config import PhaseLiftConfig
    from twoace.ops.phaselift import phaselift_bm, phaselift_bm_pair

    n, m = 16, 200
    rng = np.random.default_rng(2)
    a = ((rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
         / np.sqrt(2)).astype(np.complex64)
    x_true = ((rng.normal(size=n) + 1j * rng.normal(size=n))
              / np.sqrt(2)).astype(np.complex64)
    b = (np.abs(a @ x_true) ** 2).astype(np.float32)
    cfg = PhaseLiftConfig(max_iters=2000, lam=1e-4, bm_rank=4)
    key = jax.random.PRNGKey(0)

    res_c = phaselift_bm(key, jnp.asarray(a), jnp.asarray(b), cfg)
    res_p = phaselift_bm_pair(key, _pair(a), jnp.asarray(b), cfg)
    x_p = np.asarray(res_p.x_re) + 1j * np.asarray(res_p.x_im)
    db_c = _nmse_db(np.asarray(res_c.x), x_true)
    db_p = _nmse_db(x_p, x_true)
    assert db_c < -15
    assert db_p < -15


def test_matmul_precision_modes_agree_on_cpu():
    """cfg.matmul_precision selects the solver's trace-time matmul
    precision (the accuracy/throughput knob — see config.AdmmConfig);
    on CPU f32 matmuls are exact in every mode, so both modes must
    produce identical recoveries (guards the context plumbing + jit
    cache-key separation)."""
    nt = nr = 4
    n, m = 16, 64
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    x = np.outer(_steer(nr, 0.3), _steer(nt, -0.2).conj()).T.reshape(-1)
    b = jnp.asarray(np.abs(a @ x), jnp.float32)
    out = {}
    for prec in ("float32", "default"):
        cfg = AdmmConfig(maxiter=80, n_restarts=1, matmul_precision=prec)
        res = solve_lowrank_multi_pair(jax.random.PRNGKey(1), _pair(a), b,
                                       nt, nr, cfg)
        out[prec] = (np.asarray(res.x.re) + 1j * np.asarray(res.x.im),
                     int(res.iters))
    np.testing.assert_allclose(out["float32"][0].real,
                               out["default"][0].real, atol=1e-6)
    np.testing.assert_allclose(out["float32"][0].imag,
                               out["default"][0].imag, atol=1e-6)
    assert out["float32"][1] == out["default"][1]


def test_warm_schedule_preserves_solution_on_cpu():
    """cfg.warm_iters splits every inner solve into a default-precision
    warm loop + an f32 tail (the mixed-precision schedule,
    config.AdmmConfig.warm_iters).  On CPU both phases are exact f32, so
    the schedule must recover the same channel as the pure path (not
    bitwise: the phase switch resets the best-so-far objective and
    convergence flags, so trajectories legitimately differ by a few
    iterations) and stay within the iteration budget."""
    nt = nr = 4
    n, m = 16, 64
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 4, (m, n))
    a = (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)
    x = np.outer(_steer(nr, 0.4), _steer(nt, -0.6).conj()).T.reshape(-1)
    b = jnp.asarray(np.abs(a @ x), jnp.float32)

    out = {}
    for warm in (0, 40):
        cfg = AdmmConfig(maxiter=120, n_restarts=1, warm_iters=warm)
        res = solve_lowrank_multi_pair(jax.random.PRNGKey(2), _pair(a), b,
                                       nt, nr, cfg)
        xe = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
        c = np.vdot(xe, x) / max(np.vdot(xe, xe).real, 1e-30)
        nmse = (np.linalg.norm(x - c * xe) ** 2 / np.linalg.norm(x) ** 2)
        out[warm] = (nmse, int(res.iters), float(res.quality))
        # per-solve budget respected: it carries across phases, so the
        # total stays <= maxiter * (solves on the selected path)
        assert int(res.iters) <= 120 * 4, res.iters
    assert out[0][0] < 1e-3 and out[40][0] < 1e-3, out
    assert abs(out[0][2] - out[40][2]) < 0.05
