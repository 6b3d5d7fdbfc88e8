"""Pair-representation complex arithmetic must match the complex-dtype path
bit-for-bit (up to float32 rounding) — it is the production hot path."""

import numpy as np
import jax
import jax.numpy as jnp

from twoace.ops import cplx
from twoace.ops.prox import (
    magnitude_prox,
    profile_ladder,
    spectral_profile_prox,
)


def _rand_c(rng, *shape):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape))
            / np.sqrt(2)).astype(np.complex64)


def test_pair_matmul_matches_complex():
    rng = np.random.default_rng(0)
    a = _rand_c(rng, 24, 16)
    b = _rand_c(rng, 16, 8)
    out = cplx.matmul(cplx.from_complex(a), cplx.from_complex(b))
    np.testing.assert_allclose(np.asarray(cplx.to_complex(out)), a @ b,
                               atol=1e-5)
    outh = cplx.matmul_herm_t(cplx.from_complex(a), cplx.from_complex(a))
    np.testing.assert_allclose(np.asarray(cplx.to_complex(outh)),
                               a.conj().T @ a, atol=1e-5)


def test_embedding_roundtrip():
    rng = np.random.default_rng(1)
    h = _rand_c(rng, 6, 6)
    h = h + h.conj().T
    emb = cplx.embed_hermitian(cplx.from_complex(h))
    np.testing.assert_allclose(np.asarray(emb), np.asarray(emb).T, atol=1e-6)
    back = cplx.unembed(emb, 6)
    np.testing.assert_allclose(np.asarray(cplx.to_complex(back)), h,
                               atol=1e-6)
    # embedded eigenvalues = duplicated complex eigenvalues
    w_emb = np.linalg.eigvalsh(np.asarray(emb))[::-1]
    w_c = np.linalg.eigvalsh(h)[::-1]
    np.testing.assert_allclose(w_emb[0::2], w_c, atol=1e-5)


def test_pair_magnitude_prox_matches():
    rng = np.random.default_rng(2)
    ax = _rand_c(rng, 20, 5)
    md = _rand_c(rng, 20, 5)
    b = rng.uniform(0.5, 2.0, 20).astype(np.float32)
    mu = 0.37
    ref = magnitude_prox(jnp.asarray(ax), jnp.asarray(b), jnp.asarray(md),
                         mu, scale_by_row=True)
    out = cplx.magnitude_prox_rows(cplx.from_complex(ax), jnp.asarray(b),
                                   cplx.from_complex(md), mu)
    np.testing.assert_allclose(np.asarray(cplx.to_complex(out)),
                               np.asarray(ref), atol=1e-5)


def test_pair_spectral_prox_matches():
    rng = np.random.default_rng(3)
    nt = nr = 8
    z = _rand_c(rng, 64, 4)
    ladder = profile_ladder(nt, nr, 100, 64, False)
    ref = spectral_profile_prox(jnp.asarray(z), nt, nr, ladder)
    out = cplx.spectral_profile_prox_pair(cplx.from_complex(z), nt, nr,
                                          ladder, sweeps=10)
    np.testing.assert_allclose(np.asarray(cplx.to_complex(out)),
                               np.asarray(ref), atol=2e-4)


def test_pair_admm_iteration_matches_complex_iteration():
    """One fused pair-form iteration == one complex-form iteration."""
    rng = np.random.default_rng(4)
    nt = nr = 4
    n, m, r = 16, 40, 6
    a = _rand_c(rng, m, n)
    b = np.abs(_rand_c(rng, m)).astype(np.float32)
    u = np.linalg.inv(a.conj().T @ a + np.eye(n)).astype(np.complex64)
    y = _rand_c(rng, m, r)
    z = _rand_c(rng, n, r)
    md = _rand_c(rng, m, r)
    nd = _rand_c(rng, n, r)
    mu = 0.21
    ladder = profile_ladder(nt, nr, m, n, False)

    # complex reference
    rhs = a.conj().T @ (y - md / mu) + (z - nd / mu)
    x = u @ rhs
    ax = a @ x
    y_ref = np.asarray(magnitude_prox(jnp.asarray(ax), jnp.asarray(b),
                                      jnp.asarray(md), mu, True))
    z_ref = np.asarray(spectral_profile_prox(jnp.asarray(x + nd / mu), nt,
                                             nr, ladder))

    step = cplx.admm_iteration_pair(cplx.from_complex(a), jnp.asarray(b),
                                    cplx.from_complex(u), nt, nr, ladder)
    y2, z2, m2, n2, mu2 = step((cplx.from_complex(y), cplx.from_complex(z),
                                cplx.from_complex(md), cplx.from_complex(nd),
                                jnp.asarray(mu, jnp.float32)))
    np.testing.assert_allclose(np.asarray(cplx.to_complex(y2)), y_ref,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(cplx.to_complex(z2)), z_ref,
                               atol=1e-3)
    np.testing.assert_allclose(float(mu2), mu * 1.03, rtol=1e-6)


def test_graft_entry_contract():
    """entry() must return a jittable fn + args that run on CPU."""
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    for o in out[:-1]:
        assert np.isfinite(np.asarray(o)).all()


def test_warm_basis_prox_matches_cold():
    """Warm-started 1-sweep Z-prox tracks the cold 8-sweep prox across a
    scanned ADMM run (the Gram varies slowly between iterations)."""
    from twoace.ops.cplx import Pair, admm_iteration_pair, matmul
    from twoace.ops.prox import profile_ladder

    nt = nr = 8
    n, m, r = nt * nr, 256, 8
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 4, (m, n))
    a_np = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)
    x_true = (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)
    b = jnp.asarray(np.abs(a_np @ x_true), jnp.float32)
    u_np = np.linalg.inv(a_np.conj().T @ a_np + np.eye(n))
    ladder = profile_ladder(nt, nr, m, n, False)

    def f32p(x):
        return Pair(jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32))

    a = f32p(a_np)
    u_mat = f32p(u_np)
    x0 = rng.normal(size=(n, r)).astype(np.float32)
    y0 = matmul(a, Pair(jnp.asarray(x0), jnp.zeros((n, r), jnp.float32)))
    base = (y0, Pair(jnp.asarray(x0), jnp.zeros((n, r), jnp.float32)),
            Pair(jnp.zeros((m, r), jnp.float32), jnp.zeros((m, r), jnp.float32)),
            Pair(jnp.zeros((n, r), jnp.float32), jnp.zeros((n, r), jnp.float32)),
            jnp.asarray(1e-3, jnp.float32))

    def run(step, state, iters=60):
        for _ in range(iters):
            state = step(state)
        return state

    cold = run(jax.jit(admm_iteration_pair(a, b, u_mat, nt, nr, ladder,
                                           sweeps=8)), base)
    warm = run(jax.jit(admm_iteration_pair(a, b, u_mat, nt, nr, ladder,
                                           sweeps=1, warm_basis=True)),
               base + (jnp.eye(2 * nr, dtype=jnp.float32),))

    def resid(state):
        y = state[0]
        amp = jnp.sqrt(jnp.sum(y.re ** 2 + y.im ** 2, axis=1))
        return float(jnp.linalg.norm(amp - b) / jnp.linalg.norm(b))

    rc, rw = resid(cold), resid(warm)
    # both converge toward fitting the magnitudes, at matching rates
    assert rw < 0.35
    assert abs(rw - rc) < 0.1
    # iterates stay close in the z (low-rank) block
    zc, zw = cold[1], warm[1]
    rel = (np.linalg.norm(np.asarray(zc.re) - np.asarray(zw.re))
           / max(np.linalg.norm(np.asarray(zc.re)), 1e-9))
    assert rel < 0.2


def test_transposed_iteration_matches_untransposed():
    """admm_iteration_pair_t (r-leading layout) == admm_iteration_pair with
    warm_basis=True, state-for-state, across several iterations."""
    from twoace.ops.cplx import (Pair, admm_iteration_pair,
                                     admm_iteration_pair_t, matmul)
    from twoace.ops.prox import profile_ladder

    nt = nr = 4
    n, m, r = nt * nr, 64, 6
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 4, (m, n))
    a_np = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)
    x_true = (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)
    b = jnp.asarray(np.abs(a_np @ x_true), jnp.float32)
    u_np = np.linalg.inv(a_np.conj().T @ a_np + np.eye(n))
    ladder = profile_ladder(nt, nr, m, n, False)

    def f32p(x):
        return Pair(jnp.asarray(np.real(x), jnp.float32),
                    jnp.asarray(np.imag(x), jnp.float32))

    def tp(p):
        return Pair(p.re.T, p.im.T)

    a, u_mat = f32p(a_np), f32p(u_np)
    x0 = rng.normal(size=(n, r)).astype(np.float32)
    z0 = Pair(jnp.asarray(x0), jnp.zeros((n, r), jnp.float32))
    y0 = matmul(a, z0)
    eye = jnp.eye(2 * nr, dtype=jnp.float32)
    zeros_m = Pair(jnp.zeros((m, r), jnp.float32),
                   jnp.zeros((m, r), jnp.float32))
    zeros_n = Pair(jnp.zeros((n, r), jnp.float32),
                   jnp.zeros((n, r), jnp.float32))
    mu = jnp.asarray(1e-3, jnp.float32)

    s_ref = (y0, z0, zeros_m, zeros_n, mu, eye)
    s_t = (tp(y0), tp(z0), tp(zeros_m), tp(zeros_n), mu, eye)

    step_ref = jax.jit(admm_iteration_pair(a, b, u_mat, nt, nr, ladder,
                                           sweeps=2, warm_basis=True))
    step_t = jax.jit(admm_iteration_pair_t(a, b, u_mat, nt, nr, ladder,
                                           sweeps=2))
    for it in range(8):
        s_ref = step_ref(s_ref)
        s_t = step_t(s_t)
        for k, (pr, pt) in enumerate(zip(s_ref[:4], s_t[:4])):
            np.testing.assert_allclose(np.asarray(pt.re), np.asarray(pr.re).T,
                                       atol=2e-4, err_msg=f"it{it} slot{k}")
            np.testing.assert_allclose(np.asarray(pt.im), np.asarray(pr.im).T,
                                       atol=2e-4, err_msg=f"it{it} slot{k}")
    np.testing.assert_allclose(float(s_t[4]), float(s_ref[4]), rtol=1e-5)


def test_perturbative_eig_tracks_jacobi_in_admm():
    """eig_mode='perturb' converges the ADMM like the warm Jacobi sweep."""
    from twoace.ops.cplx import (Pair, admm_iteration_pair_t, matmul)
    from twoace.ops.prox import profile_ladder

    nt = nr = 8
    n, m, r = nt * nr, 256, 8
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 4, (m, n))
    a_np = np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)
    x_true = (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)
    b = jnp.asarray(np.abs(a_np @ x_true), jnp.float32)
    u_np = np.linalg.inv(a_np.conj().T @ a_np + np.eye(n))
    ladder = profile_ladder(nt, nr, m, n, False)

    def f32p(x):
        return Pair(jnp.asarray(np.real(x), jnp.float32),
                    jnp.asarray(np.imag(x), jnp.float32))

    a, u_mat = f32p(a_np), f32p(u_np)
    x0 = rng.normal(size=(r, n)).astype(np.float32)
    z0 = Pair(jnp.asarray(x0), jnp.zeros((r, n), jnp.float32))
    y0 = Pair(z0.re @ a_np.real.T.astype(np.float32)
              - z0.im @ a_np.imag.T.astype(np.float32),
              z0.re @ a_np.imag.T.astype(np.float32)
              + z0.im @ a_np.real.T.astype(np.float32))
    from twoace.ops.cplx import panel_gram_basis
    base = (y0, z0,
            Pair(jnp.zeros((r, m), jnp.float32), jnp.zeros((r, m), jnp.float32)),
            Pair(jnp.zeros((r, n), jnp.float32), jnp.zeros((r, n), jnp.float32)),
            jnp.asarray(1e-3, jnp.float32),
            panel_gram_basis(z0, nt, nr))

    def resid(state):
        y = state[0]
        amp = jnp.sqrt(jnp.sum(y.re ** 2 + y.im ** 2, axis=0))
        return float(jnp.linalg.norm(amp - b) / jnp.linalg.norm(b))

    outs = {}
    for mode in ("jacobi", "perturb"):
        step = jax.jit(admm_iteration_pair_t(a, b, u_mat, nt, nr, ladder,
                                             sweeps=1, eig_mode=mode))
        s = base
        for _ in range(60):
            s = step(s)
        outs[mode] = resid(s)
    assert outs["perturb"] < 0.35
    assert abs(outs["perturb"] - outs["jacobi"]) < 0.1
