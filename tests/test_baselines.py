"""Tests for PhaseLift, OMP, GAMP, two-stage, CPRL baselines (SURVEY §2.1
S9-S11)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import PhaseLiftConfig, MethodFlags, ArrayConfig
from twoace.ops.cpr_baselines import (
    conventional_cs,
    cprl,
    lifted_omp,
    sparse_phaselift,
)
from twoace.ops.dispatch import admm_v2, recover_channel, recover_sparse
from twoace.ops.gamp import embgamp, prgamp, vamp_cs
from twoace.ops.omp import omp
from twoace.ops.phaselift import phaselift_bm, phaselift_fista
from twoace.ops.twostage import static_mcs, two_stage_recovery


def _rand_c(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) / np.sqrt(2)


def _align(x, ref):
    ph = np.exp(1j * np.angle(np.vdot(x, ref)))
    return x * ph


def test_omp_exact_sparse_recovery():
    rng = np.random.default_rng(0)
    m, n, s = 40, 120, 3
    a = _rand_c(rng, m, n)
    x = np.zeros(n, complex)
    sup = rng.choice(n, s, replace=False)
    x[sup] = _rand_c(rng, s)
    y = a @ x
    xr = np.asarray(omp(jnp.asarray(a), jnp.asarray(y), max_steps=s))
    np.testing.assert_allclose(xr, x, atol=1e-8)


def test_phaselift_fista_rank1_recovery():
    rng = np.random.default_rng(1)
    m, n = 160, 16
    x = _rand_c(rng, n)
    a = _rand_c(rng, m, n)
    b = np.abs(a @ x) ** 2
    cfg = PhaseLiftConfig(lam=1e-3, max_iters=400)
    res = phaselift_fista(jnp.asarray(a), jnp.asarray(b), cfg)
    xr = _align(np.asarray(res.x), x)
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.05, err


def test_phaselift_bm_rank1_recovery(key):
    rng = np.random.default_rng(2)
    m, n = 200, 16
    x = _rand_c(rng, n)
    a = _rand_c(rng, m, n)
    b = np.abs(a @ x) ** 2
    cfg = PhaseLiftConfig(lam=1e-4, max_iters=2000, bm_rank=4)
    res = phaselift_bm(key, jnp.asarray(a), jnp.asarray(b), cfg)
    xr = _align(np.asarray(res.x), x)
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.1, err


def test_embgamp_sparse_awgn():
    rng = np.random.default_rng(3)
    m, n, s = 60, 200, 4
    a = _rand_c(rng, m, n) / np.sqrt(m)
    x = np.zeros(n, complex)
    sup = rng.choice(n, s, replace=False)
    x[sup] = _rand_c(rng, s)
    y = a @ x + 1e-3 * _rand_c(rng, m)
    xr = np.asarray(embgamp(jnp.asarray(y), jnp.asarray(a), snr_db=40.0,
                            lam0=s / n))
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.1, err


def test_vamp_sparse_awgn():
    rng = np.random.default_rng(5)
    m, n, s = 60, 200, 4
    a = _rand_c(rng, m, n) / np.sqrt(m)
    x = np.zeros(n, complex)
    sup = rng.choice(n, s, replace=False)
    x[sup] = _rand_c(rng, s)
    y = a @ x + 1e-3 * _rand_c(rng, m)
    xr = np.asarray(vamp_cs(jnp.asarray(y), jnp.asarray(a), snr_db=40.0,
                            lam0=s / n))
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.1, err


def test_vamp_ill_conditioned_rows():
    # correlated rows (directional-codebook-like); VAMP's exact LMMSE stage
    # handles the non-iid A where plain GAMP diverges
    rng = np.random.default_rng(7)
    m, n, s = 80, 120, 3
    base = _rand_c(rng, m // 4, n)
    a = (np.repeat(base, 4, axis=0)
         + 0.1 * _rand_c(rng, m, n)) / np.sqrt(m)
    x = np.zeros(n, complex)
    x[rng.choice(n, s, replace=False)] = _rand_c(rng, s)
    y = a @ x + 1e-4 * _rand_c(rng, m)
    xr = np.asarray(vamp_cs(jnp.asarray(y), jnp.asarray(a), snr_db=50.0,
                            lam0=s / n, iters=100))
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.15, err


def test_prgamp_runs_and_fits_magnitudes(key):
    rng = np.random.default_rng(4)
    m, n, s = 120, 64, 2
    a = _rand_c(rng, m, n) / np.sqrt(m)
    x = np.zeros(n, complex)
    x[rng.choice(n, s, replace=False)] = _rand_c(rng, s) * 3
    y = np.abs(a @ x)
    xr = np.asarray(prgamp(jnp.asarray(y), jnp.asarray(a)))
    fit = np.linalg.norm(np.abs(a @ xr) - y) / np.linalg.norm(y)
    assert fit < 0.5, fit


def test_static_mcs_monotone():
    from twoace.config import TwoStageConfig
    cfg = TwoStageConfig()
    assert static_mcs(16, 500, 3, cfg) <= static_mcs(64, 500, 3, cfg)
    assert static_mcs(64, 500, 3, cfg) <= 64


def test_two_stage_plomp_recovery():
    """PLOMP pipeline: sparse signal through a *low-effective-rank* matrix
    (the FW @ AD matrices of the reference are coherent/compressible — the
    whole point of the SVD split, ref: My_TwoStage_Recovery.m:81-100)."""
    rng = np.random.default_rng(5)
    m, n, s, r0 = 150, 300, 2, 12
    a = _rand_c(rng, m, r0) @ _rand_c(rng, r0, n)
    z = np.zeros(n, complex)
    sup = rng.choice(n, s, replace=False)
    z[sup] = _rand_c(rng, s) + 2.0   # well-separated magnitudes
    b = np.abs(a @ z) ** 2
    res = two_stage_recovery(jnp.asarray(b), jnp.asarray(a), s)
    # stage-1 must reproduce the measured intensities through P
    xr = np.asarray(res.plomp)
    resid = a @ xr
    fit = np.linalg.norm(np.abs(resid) ** 2 - b) / np.linalg.norm(b)
    assert fit < 0.1, fit
    # OMP support must land on dictionary columns equivalent to the truth:
    # with a rank-12 A, columns are not identifiable individually, so check
    # the *measurement-space* agreement above plus sparsity of the output
    assert np.count_nonzero(np.abs(xr) > 1e-6 * np.abs(xr).max()) <= 2 * s + 2


def test_cprl_small():
    rng = np.random.default_rng(6)
    m, n = 80, 12
    x = np.zeros(n, complex)
    x[[2, 7]] = [2.0, 1.5 + 1j]
    a = _rand_c(rng, m, n)
    b = np.abs(a @ x) ** 2
    xr = np.asarray(cprl(jnp.asarray(b), jnp.asarray(a), mu=1e-3, iters=300))
    xr = _align(xr, x)
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 0.2, err


def test_lifted_omp_sparse():
    # MyOMP recovers a *sparse* x: vec(xx^H) then has s^2 nonzeros
    # (ref: MyOMP.m:63-82)
    rng = np.random.default_rng(7)
    m, n, s0 = 100, 10, 2
    x = np.zeros(n, complex)
    x[[1, 6]] = [2.0, 1.0 + 1j]
    a = _rand_c(rng, m, n)
    b = np.abs(a @ x) ** 2
    xr = np.asarray(lifted_omp(jnp.asarray(b), jnp.asarray(a), s=s0 * s0))
    corr = np.abs(np.vdot(xr, x)) / (np.linalg.norm(xr) * np.linalg.norm(x))
    assert corr > 0.9, corr


def test_sparse_phaselift_screen():
    rng = np.random.default_rng(8)
    m, n = 120, 200
    z = np.zeros(n, complex)
    z[[5, 50]] = [3.0, 2.0 + 1j]
    a = _rand_c(rng, m, n)
    b = np.abs(a @ z) ** 2
    xr = np.asarray(sparse_phaselift(jnp.asarray(b), jnp.asarray(a)))
    assert np.count_nonzero(xr) <= int(np.ceil(0.05 * n))


def test_conventional_cs_perfect_phase():
    rng = np.random.default_rng(9)
    m, n, s = 50, 150, 3
    a = _rand_c(rng, m, n) / np.sqrt(m)
    x = np.zeros(n, complex)
    x[rng.choice(n, s, replace=False)] = _rand_c(rng, s)
    y = a @ x
    xr = np.asarray(conventional_cs(jnp.asarray(y), jnp.asarray(a), s, 1e-4,
                                    use_gamp=False))
    np.testing.assert_allclose(xr, x, atol=1e-6)


def test_admm_v2_version_dispatch(key):
    rng = np.random.default_rng(10)
    nt = nr = 4
    n = nt * nr
    m = 3 * n
    h = _rand_c(rng, nr, 1) @ _rand_c(rng, 1, nt)     # rank-1 channel
    x = h.T.reshape(-1)
    a = jnp.asarray(np.exp(1j * rng.integers(0, 4, (m, n)) * np.pi / 2)
                    / np.sqrt(n))
    b = jnp.abs(a @ jnp.asarray(x))
    for version in [0, 1, 2, 4]:
        res = admm_v2(key, b, a, nt, nr, version)
        assert res.x.shape == (n,)
        assert np.isfinite(np.asarray(res.x)).all(), version


def test_admm_v2_escalation_fallback(key):
    """Out-of-range versions hit the escalation retry loop
    (ADMM_v2.m:33-44): V2 solver with the RZ-into-lambda / R-into-width
    quirk call, breaking on nonzero quality (MATLAB float truthiness —
    see dispatch._admm_v2_escalation).  A well-posed rank-1 problem must
    recover on the first attempt."""
    rng = np.random.default_rng(12)
    nt = nr = 4
    n = nt * nr
    m = 3 * n
    h = _rand_c(rng, nr, 1) @ _rand_c(rng, 1, nt)
    x = h.T.reshape(-1)
    a = jnp.asarray(np.exp(1j * rng.integers(0, 4, (m, n)) * np.pi / 2)
                    / np.sqrt(n))
    b = jnp.abs(a @ jnp.asarray(x))
    res = admm_v2(key, b, a, nt, nr, version=5)
    assert res.x.shape == (n,)
    assert np.isfinite(np.asarray(res.x)).all()
    assert float(res.quality) != 0.0      # the loop's break condition
    # the lam=5 ridge shrinks the fit but the support/direction must hold
    xe = np.asarray(res.x)
    c = np.vdot(xe, x) / max(np.vdot(xe, xe).real, 1e-30)
    nmse = np.linalg.norm(x - c * xe) ** 2 / np.linalg.norm(x) ** 2
    assert nmse < 0.5, nmse


def test_recover_channel_multi_method(key):
    rng = np.random.default_rng(11)
    cfg = ArrayConfig(nt=4, nr=4)
    n = cfg.n
    m = 40
    x = _rand_c(rng, n)
    a = jnp.asarray(_rand_c(rng, m, n))
    b = jnp.abs(a @ jnp.asarray(x)) * 2e5   # testbed-scale amplitudes
    flags = MethodFlags(admm_lowrank_v4=True, phaselift=True)
    out = recover_channel(key, b, a, flags, cfg, s=2)
    assert set(out) == {"admm_lowrank_v4", "phaselift"}
    for v in out.values():
        assert v.shape == (n,)
        assert np.isfinite(np.asarray(v)).all()


def test_unconventional_cs_unit_norm(key):
    """Norm-constrained ridge LS: ||x|| = 1 when achievable in lam ∈ [0,1]
    (ref My_Unconventional_CS.m:12-15)."""
    from twoace.ops.cpr_baselines import unconventional_cs

    rng = np.random.default_rng(0)
    m, n = 40, 16
    # small-amplitude A so lam in [0, 1] (the reference's fmincon bounds)
    # can actually reach ||x|| = 1
    f = 0.05 * jnp.asarray(rng.normal(size=(n, m)) + 1j * rng.normal(size=(n, m)))
    x_true = jnp.asarray(rng.normal(size=n) + 1j * rng.normal(size=n))
    x_true = 3.0 * x_true / jnp.linalg.norm(x_true)   # needs shrinking
    b = f.T @ x_true
    x = unconventional_cs(b, f)
    np.testing.assert_allclose(float(jnp.linalg.norm(x)), 1.0, rtol=1e-3)
    # direction is preserved (ridge shrinks, does not rotate, here since
    # b lies in the row space)
    corr = np.abs(np.vdot(np.asarray(x), np.asarray(x_true)))
    assert corr / (np.linalg.norm(x_true)) > 0.8


def test_recover_channel_bf_passthrough(key):
    """Recover_Channel_bf (ref: Recover_Channel_bf.m:1-45): re-runs the
    ADMM variants on fresh beamforming-time measurements, but passes
    through the earlier PhaseLift/PLOMP/PLGAMP estimates unchanged."""
    from twoace.ops.dispatch import recover_channel_bf

    rng = np.random.default_rng(21)
    cfg = ArrayConfig(nt=4, nr=4)
    n = cfg.n
    m = 40
    x = _rand_c(rng, n)
    a = jnp.asarray(_rand_c(rng, m, n))
    b = jnp.abs(a @ jnp.asarray(x)) * 2e5
    flags = MethodFlags(admm_lowrank_v4=True, phaselift=True)
    prev = {"phaselift": jnp.asarray(_rand_c(rng, n))}
    out = recover_channel_bf(key, b, a, flags, cfg, prev)
    assert set(out) == {"admm_lowrank_v4", "phaselift"}
    np.testing.assert_array_equal(np.asarray(out["phaselift"]),
                                  np.asarray(prev["phaselift"]))
    assert np.isfinite(np.asarray(out["admm_lowrank_v4"])).all()
    # enabled lifted method missing from `recovered` is an error
    import pytest as _pytest
    with _pytest.raises(ValueError):
        recover_channel_bf(key, b, a, MethodFlags(plomp=True), cfg, {})


def test_phaselift_fista_kkt_optimality():
    """PhaseLift is convex, so optimality is checkable without the
    reference's TFOCS: at the reference defaults (lam = 5e-2, maxIts 4e3,
    MyPhaseLift.m:83-101) the FISTA iterate must satisfy the KKT
    conditions of  min_{X>=0} 0.5||b - A(X)||^2 + lam tr(X):
    G = A*(A(X) - b) + lam I  is PSD (dual feasibility) and <G, X> = 0
    (complementary slackness).  Measured residuals at 4000 iters are
    ~1e-12 (float64); bounds pinned 100x above the measurement."""
    from twoace.ops.phaselift import _adjoint, _apply_linop

    rng = np.random.default_rng(0)
    n, m = 8, 48
    a = _rand_c(rng, m, n) / np.sqrt(n)
    x = _rand_c(rng, n)
    b = np.abs(a @ x) ** 2

    cfg = PhaseLiftConfig()             # lam=5e-2, max_iters=4000 (ref)
    res = phaselift_fista(jnp.asarray(a), jnp.asarray(b), cfg)
    x_lift = np.asarray(res.lifted)
    r = np.asarray(_apply_linop(jnp.asarray(a), jnp.asarray(x_lift))) - b
    g = np.asarray(_adjoint(jnp.asarray(a), jnp.asarray(r))) \
        + cfg.lam * np.eye(n)
    g = 0.5 * (g + g.conj().T)
    scale = np.linalg.norm(g)
    assert np.linalg.eigvalsh(g).min() > -1e-8 * max(scale, 1.0)
    assert abs(np.real(np.trace(g @ x_lift))) \
        < 1e-8 * max(scale * np.real(np.trace(x_lift)), 1.0)
    # and the objective cannot be beaten by a longer run (global optimum)
    res_long = phaselift_fista(jnp.asarray(a), jnp.asarray(b),
                               PhaseLiftConfig(max_iters=12000))
    assert float(res.objective) <= float(res_long.objective) + 1e-6
