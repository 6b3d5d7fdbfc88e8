"""Unit tests for prox operators, eigensolvers, and the ADMM core (SURVEY §4:
per-prox-operator closed-form tests + oracle end-to-end recovery)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import AdmmConfig, ArrayConfig, ChannelConfig
from twoace.models import generate_channel
from twoace.ops.admm import infer_admm, solve_lowrank_multi, solve_minl2
from twoace.ops.eigh_jacobi import eigh_desc, eigh_jacobi, subspace_eigh
from twoace.ops.prox import (
    magnitude_prox,
    nuclear_prox,
    profile_ladder,
    spectral_profile_prox,
)
from twoace.ops.spectral_init import spectral_initialize
from twoace.utils.metrics import nmse_h_projection


def _rand_c(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)


# ---------------------------------------------------------------- eigensolvers

def test_eigh_jacobi_matches_numpy():
    rng = np.random.default_rng(3)
    a = _rand_c(rng, 4, 16, 16)
    a = (a + a.conj().swapaxes(-1, -2)) / 2
    w, v = eigh_jacobi(jnp.asarray(a), sweeps=10)
    wr = np.linalg.eigvalsh(a)[..., ::-1]
    np.testing.assert_allclose(np.asarray(w), wr, atol=1e-10)
    recon = np.asarray(v) @ (np.asarray(w)[..., None]
                             * np.asarray(v).conj().swapaxes(-1, -2))
    np.testing.assert_allclose(recon, a, atol=1e-10)


@pytest.mark.parametrize("n, dtype", [(2, np.complex128), (3, np.complex128),
                                      (5, np.float64), (8, np.float64)])
def test_eigh_jacobi_scanned_schedule_sizes(n, dtype):
    """The rotation rounds are scanned as one (rounds, pairs, 2) schedule:
    odd sizes (one bye per round) and the smallest sizes must still
    decompose exactly, real and complex alike."""
    rng = np.random.default_rng(n)
    a = _rand_c(rng, 3, n, n)
    if dtype == np.float64:
        a = a.real
    a = (a + a.conj().swapaxes(-1, -2)) / 2
    w, v = eigh_jacobi(jnp.asarray(a))
    assert np.asarray(w).dtype == np.float64
    np.testing.assert_allclose(np.asarray(w),
                               np.linalg.eigvalsh(a)[..., ::-1], atol=1e-10)
    recon = np.asarray(v) @ (np.asarray(w)[..., None]
                             * np.asarray(v).conj().swapaxes(-1, -2))
    np.testing.assert_allclose(recon, a, atol=1e-10)


def test_subspace_eigh_topk():
    rng = np.random.default_rng(4)
    b = _rand_c(rng, 300, 25)
    g = b @ b.conj().T
    w, v = subspace_eigh(jnp.asarray(g), 10, iters=40)
    wr = np.linalg.eigvalsh(g)[::-1][:10]
    np.testing.assert_allclose(np.asarray(w), wr, rtol=1e-8)


# ------------------------------------------------------------------- prox ops

def test_magnitude_prox_scalar_formula():
    # closed form: R = (B + mu*D) / (1 + mu), direction preserved
    # ref: inferLowRankV4_multi.m:507-509
    ax = jnp.asarray([[3.0 + 4.0j]])     # |.| = 5
    b = jnp.asarray([10.0])
    m_dual = jnp.zeros((1, 1), jnp.complex128)
    mu = 0.5
    y = magnitude_prox(ax, b, m_dual, mu, scale_by_row=False)
    expect_r = (10.0 + mu * 5.0) / (1.0 + mu)
    np.testing.assert_allclose(np.abs(np.asarray(y))[0, 0], expect_r,
                               rtol=1e-12)
    np.testing.assert_allclose(np.angle(np.asarray(y))[0, 0],
                               np.angle(3 + 4j), rtol=1e-12)


def test_magnitude_prox_row_mode():
    rng = np.random.default_rng(0)
    ax = jnp.asarray(_rand_c(rng, 7, 3))
    b = jnp.asarray(rng.uniform(0.5, 2.0, 7))
    y = magnitude_prox(ax, b, jnp.zeros_like(ax), 0.25, scale_by_row=True)
    d = np.linalg.norm(np.asarray(ax), axis=1)
    expect = (np.asarray(b) + 0.25 * d) / 1.25
    np.testing.assert_allclose(np.linalg.norm(np.asarray(y), axis=1), expect,
                               rtol=1e-12)


def test_profile_ladder_static_selection():
    # ref: inferLowRankV4_multi.m:437-464 for sz=16: r=(2,3,4,8)
    assert profile_ladder(16, 16, 100, 256, False) == \
        ((3, 0.9), (4, 0.95), (8, 0.995))   # r0=2 <= 2 -> drop first level
    assert profile_ladder(16, 16, 1000, 256, False) == ((8, 0.995),)  # m>=3n
    assert profile_ladder(16, 16, 100, 256, True) == ((1, 0.95),)
    assert profile_ladder(36, 36, 100, 1296, False) == \
        ((3, 0.8), (5, 0.9), (6, 0.95), (12, 0.995))


def test_spectral_profile_prox_identity_when_satisfied():
    # exactly rank-1 Z already satisfies every ladder constraint
    rng = np.random.default_rng(1)
    nt = nr = 8
    u = _rand_c(rng, nr)
    vt = _rand_c(rng, nt)
    h = np.outer(u, vt)                  # rank-1 (nr, nt)
    x = h.T.reshape(-1)                  # vec, rx fastest
    z = jnp.asarray(x[:, None])
    ladder = profile_ladder(nt, nr, 50, 64, False)
    out = spectral_profile_prox(z, nt, nr, ladder)
    np.testing.assert_allclose(np.asarray(out), np.asarray(z), atol=1e-12)


def test_spectral_profile_prox_enforces_fraction():
    # iid full-rank Z violates the ladder; output must satisfy all constraints
    rng = np.random.default_rng(2)
    nt = nr = 16
    z = jnp.asarray(_rand_c(rng, 256, 4))
    ladder = profile_ladder(nt, nr, 100, 256, False)
    out = np.asarray(spectral_profile_prox(z, nt, nr, ladder))
    # rebuild panel and check each (r, f)
    e = out.T.reshape(4, nt, nr).transpose(2, 0, 1).reshape(nr, -1)
    s2 = np.sort(np.linalg.eigvalsh(e @ e.conj().T))[::-1]
    for r, f in ladder:
        assert s2[:r].sum() >= f * s2.sum() - 1e-9, (r, f)


def test_nuclear_prox_matches_svd_shrink():
    rng = np.random.default_rng(5)
    z = _rand_c(rng, 40, 6)
    thresh = 0.8
    out = nuclear_prox(jnp.asarray(z), thresh)
    u, s, vh = np.linalg.svd(z, full_matrices=False)
    expect = (u * np.maximum(s - thresh, 0.0)) @ vh
    np.testing.assert_allclose(np.asarray(out), expect, atol=1e-10)


def test_spectral_initialize_rank1_direction():
    rng = np.random.default_rng(6)
    n, m = 64, 512
    x_true = _rand_c(rng, n)
    a = _rand_c(rng, m, n)
    b = jnp.asarray(np.abs(a @ x_true))
    x0 = spectral_initialize(jnp.asarray(a), b, 5)
    # leading column should correlate strongly with the true signal
    corr = np.abs(np.vdot(np.asarray(x0)[:, 0], x_true)) / (
        np.linalg.norm(np.asarray(x0)[:, 0]) * np.linalg.norm(x_true))
    # the spectral estimator is an initializer, not a solution: expect a
    # clearly-above-chance correlation (chance ~ 1/sqrt(n) ~ 0.125 here)
    assert corr > 0.5


# ------------------------------------------------------------------ ADMM core

def test_infer_admm_phase_retrieval_gaussian():
    """Magnitude-only recovery of a random vector from gaussian measurements
    (the commented-out self-test scaffold, ref: ADMM_v2.m:13-19)."""
    rng = np.random.default_rng(7)
    n, m = 32, 256
    x_true = _rand_c(rng, n, 1)
    a = jnp.asarray(_rand_c(rng, m, n))
    b = jnp.abs(a @ jnp.asarray(x_true))[:, 0]
    x0 = spectral_initialize(a, b, 8)
    x, y, converged = infer_admm(a, b, x0, scale_by_row=True, prox=None,
                                 maxiter=500)
    # pick best column by objective, compare up to global phase
    ax = np.abs(np.asarray(a @ x))
    resid = np.linalg.norm(
        np.sqrt((ax ** 2).sum(1)) - np.asarray(b)) / np.linalg.norm(b)
    assert resid < 0.05


@pytest.mark.parametrize("prox_kind", ["spectral_profile", "nuclear"])
def test_solve_lowrank_multi_recovers_channel(key, prox_kind):
    """Oracle end-to-end: seeded Eq.-23 channel, random 2-bit codebook,
    noiseless RSS -> A2 recovery NMSE well below -10 dB."""
    cfg = ArrayConfig(nt=8, nr=8)
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=2, rician_k=0),
                          batch=1, dtype=jnp.complex128)
    n = cfg.n
    m = 4 * n
    k2 = jax.random.fold_in(key, 2)
    phases = jax.random.randint(k2, (m, n), 0, 4)
    a = jnp.exp(1j * phases * (np.pi / 2)) / np.sqrt(n)
    b = jnp.abs(a @ ch.vec_h[0])
    res = solve_lowrank_multi(jax.random.fold_in(key, 3), a, b, cfg.nt,
                              cfg.nr, AdmmConfig(), prox_kind=prox_kind)
    nmse = float(nmse_h_projection(res.x[None], ch.vec_h)[0])
    assert nmse < 0.1, f"nmse={nmse} ({10*np.log10(nmse):.1f} dB)"
    assert float(res.quality) > 0.8


def test_solve_lowrank_multi_x_seed(key):
    """x_seed warm-start hook: a truth seed must not degrade recovery (the
    scaffold's ArgMinX arbitration keeps the best column either way), and
    a garbage seed must be survivable — recovery still succeeds off the
    spectral columns."""
    cfg = ArrayConfig(nt=8, nr=8)
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=2, rician_k=0),
                          batch=1, dtype=jnp.complex128)
    n = cfg.n
    m = 4 * n
    k2 = jax.random.fold_in(key, 2)
    phases = jax.random.randint(k2, (m, n), 0, 4)
    a = jnp.exp(1j * phases * (np.pi / 2)) / np.sqrt(n)
    b = jnp.abs(a @ ch.vec_h[0])
    for seed in [jnp.asarray(ch.vec_h[0]),
                 jnp.ones((n,), jnp.complex128)]:
        res = solve_lowrank_multi(jax.random.fold_in(key, 3), a, b, cfg.nt,
                                  cfg.nr, AdmmConfig(), x_seed=seed)
        nmse = float(nmse_h_projection(res.x[None], ch.vec_h)[0])
        assert nmse < 0.1, f"nmse={nmse} ({10*np.log10(nmse):.1f} dB)"


def test_solve_minl2_runs(key):
    cfg = ArrayConfig(nt=4, nr=4)
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=1, rician_k=0),
                          batch=1, dtype=jnp.complex128)
    n = cfg.n
    m = 4 * n
    k2 = jax.random.fold_in(key, 2)
    phases = jax.random.randint(k2, (m, n), 0, 4)
    a = jnp.exp(1j * phases * (np.pi / 2)) / np.sqrt(n)
    b = jnp.abs(a @ ch.vec_h[0])
    res = solve_minl2(jax.random.fold_in(key, 3), a, b)
    nmse = float(nmse_h_projection(res.x[None], ch.vec_h)[0])
    assert nmse < 0.5


def test_infer_admm_inactive_row_padding_is_exact():
    """Padding (A, b) with inactive rows (A_i = 0, b_i = 0) leaves the
    InferADMM solve unchanged — the static-shape window-padding contract of
    the mobility tracker (pipeline/mobility._pad_window): b == 0 rows prox
    to y = 0, never touch the duals, and m_eff-based normalization keeps
    the effective ridge identical."""
    rng = np.random.default_rng(5)
    nt = nr = 6
    n = nt * nr
    m, r = 64, 8
    a = jnp.asarray(_rand_c(rng, m, n))
    x_true = jnp.asarray(_rand_c(rng, n))
    b = jnp.abs(a @ x_true)
    x0 = jnp.asarray(_rand_c(rng, n, r))
    ladder = profile_ladder(nt, nr, m, n, False)

    def prox(z, mu):
        return spectral_profile_prox(z, nt, nr, ladder)

    x_dyn, y_dyn, _ = infer_admm(a, b, x0, scale_by_row=True, prox=prox,
                                 maxiter=40)

    pad = 16
    a_p = jnp.concatenate([a, jnp.zeros((pad, n), a.dtype)])
    b_p = jnp.concatenate([b, jnp.zeros((pad,), b.dtype)])
    x_pad, y_pad, _ = infer_admm(a_p, b_p, x0, scale_by_row=True, prox=prox,
                                 maxiter=40)

    np.testing.assert_allclose(np.asarray(x_pad), np.asarray(x_dyn),
                               atol=1e-8)
    # padded rows of Y are exactly zero
    np.testing.assert_array_equal(np.asarray(y_pad)[m:], 0.0)


def test_solve_lowrank_padding_recovers_channel():
    """solve_lowrank_multi on an inactive-row-padded problem recovers the
    channel as well as the unpadded solve (the full-scaffold static-pad
    path; splits differ in RNG so parity is at the recovery level)."""
    rng = np.random.default_rng(9)
    nt = nr = 6
    n = nt * nr
    m, pad = 96, 32
    bits = rng.integers(0, 4, (m, n))
    a = jnp.asarray(np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n))
    x_true = jnp.asarray(_rand_c(rng, n))
    b = jnp.abs(a @ x_true)
    cfg = AdmmConfig(maxiter=150)
    key = jax.random.PRNGKey(2)

    a_p = jnp.concatenate([a, jnp.zeros((pad, n), a.dtype)])
    b_p = jnp.concatenate([b, jnp.zeros((pad,), b.dtype)])

    def nmse_db(x):
        x = np.asarray(x)
        xt = np.asarray(x_true)
        c = np.vdot(x, xt) / max(np.vdot(x, x).real, 1e-30)
        return 10 * np.log10(np.linalg.norm(xt - c * x) ** 2
                             / np.linalg.norm(xt) ** 2)

    n_dyn = nmse_db(solve_lowrank_multi(key, a, b, nt, nr, cfg).x)
    # ladder_m = active count: without it the padded row count crosses the
    # m >= 3n overdetermined test (128 >= 108 but 96 < 108) and silently
    # selects a different constraint ladder than the dynamic solve
    # (profile_ladder, ref inferLowRankV4_multi.m:447)
    n_pad = nmse_db(solve_lowrank_multi(key, a_p, b_p, nt, nr, cfg,
                                        ladder_m=m).x)
    # the padded solve draws its train/test splits over the padded row
    # count, so the two runs are different Monte-Carlo draws of the same
    # problem — parity is "both recover", not identical iterates (the
    # iterate-exact padding contract is test_infer_admm_inactive_row_
    # padding_is_exact, where no splits are involved)
    assert n_pad < -20.0, n_pad
    assert n_dyn < -15.0, n_dyn


def test_ladder_m_snap_preserves_ladder_selection():
    """pipeline.mobility._ladder_m_for_window: the snapped canonical count
    always selects the SAME constraint ladders (full-data and train-split)
    as the true active count — with at most 3 distinct values per run."""
    import math as _math

    from twoace.ops.prox import profile_ladder
    from twoace.pipeline.mobility import _ladder_m_for_window

    nt = nr = 4
    n = nt * nr                      # 3n = 48 sits inside the sweep range
    frac = 0.95
    for m_padded in (60, 80, 200):
        seen = set()
        for m_active in range(5, m_padded + 1, 3):
            snap = _ladder_m_for_window(m_active, m_padded, n, frac)
            lm = m_padded if snap is None else snap
            seen.add(lm)
            for use_r1 in (False, True):
                assert profile_ladder(nt, nr, lm, n, use_r1) == \
                    profile_ladder(nt, nr, m_active, n, use_r1), \
                    (m_active, m_padded, lm)
                tr_lm = _math.floor(lm * frac)
                tr_act = _math.floor(m_active * frac)
                assert profile_ladder(nt, nr, tr_lm, n, use_r1) == \
                    profile_ladder(nt, nr, tr_act, n, use_r1), \
                    (m_active, m_padded, lm)
        assert len(seen) <= 3, seen
