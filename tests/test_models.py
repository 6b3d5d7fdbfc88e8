"""Tests for the channel / dictionary / measurement models (SURVEY §2.2)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import ArrayConfig, ChannelConfig, probe_budget_grid
from twoace.models import (
    angle_dictionary,
    generate_channel,
    generate_measurement,
    sparse_formulation,
    steering_vector,
    unvec_channel,
    vec_channel,
)
from twoace.utils.units import dbm_to_amplitude, amplitude_to_dbm


CFG = ArrayConfig(nt=8, nr=8)
CH = ChannelConfig(n_paths=2, searching_area_deg=95.0)


def test_probe_budget_grid_matches_reference():
    # ref: A2only.m:110-111 — for 16x16: round(linspace(2,32,8)).^2
    assert probe_budget_grid(16, 16) == (4, 36, 121, 225, 361, 529, 784, 1024)
    assert probe_budget_grid(4, 4) == (4, 9, 16, 25, 25, 36, 49, 64)


def test_steering_vector_unit_norm():
    a = steering_vector(jnp.sin(jnp.deg2rad(jnp.array([0.0, 17.0, -40.0]))),
                        16, CFG.k_d)
    assert a.shape == (3, 16)
    np.testing.assert_allclose(np.linalg.norm(a, axis=-1), 1.0, rtol=1e-6)


def test_vec_unvec_roundtrip(key):
    h = jax.random.normal(key, (3, 5, 7))
    v = vec_channel(h)
    assert v.shape == (3, 35)
    np.testing.assert_allclose(unvec_channel(v, 5, 7), h)
    # Rx index fastest: v[0] order is H[0,0],H[1,0],...
    np.testing.assert_allclose(v[0, :5], h[0, :, 0])


def test_channel_model_structure(key):
    ch = generate_channel(key, CFG, CH, batch=4)
    assert ch.h_matrix.shape == (4, 8, 8)
    assert ch.vec_h.shape == (4, 64)
    # gains normalized per instance (ref: Generate_Channel.m:107)
    np.testing.assert_allclose(np.linalg.norm(ch.gains, axis=-1), 1.0,
                               rtol=1e-5)
    # angles inside the searching area
    assert np.all(np.abs(ch.aod_deg) <= CH.searching_area_deg / 2)
    # multipath => no Rician mixing (ref :110-111): H == dominant part
    np.testing.assert_allclose(ch.h_matrix, ch.h_dominant)


def test_rician_mixing_single_path(key):
    ch1 = generate_channel(key, CFG, ChannelConfig(n_paths=1, rician_k=5),
                           batch=2)
    assert not np.allclose(ch1.h_undominant, 0.0)
    k = 10 ** 0.7
    expect = (np.sqrt(k / (k + 1)) * ch1.h_dominant
              + np.sqrt(1 / (k + 1)) * ch1.h_undominant)
    np.testing.assert_allclose(ch1.h_matrix, expect, rtol=1e-6)


def test_channel_rank_one_when_single_path(key):
    ch = generate_channel(key, CFG, ChannelConfig(n_paths=1, rician_k=0),
                          batch=1)
    s = np.linalg.svd(np.asarray(ch.h_matrix[0]), compute_uv=False)
    assert s[1] / s[0] < 1e-5
    # Frobenius norm: sqrt(Nt*Nr)*|h| with unit gain and unit-norm steering
    np.testing.assert_allclose(np.linalg.norm(s), np.sqrt(8 * 8), rtol=1e-5)


def test_sparse_formulation_ground_truth(key):
    # On-grid channel: AD @ z must reproduce vec(H) exactly.
    ch = generate_channel(key, CFG,
                          ChannelConfig(n_paths=2, rician_k=0, on_grid=True),
                          batch=3, dtype=jnp.complex128)
    rep = sparse_formulation(CFG, ch, 95.0, dtype=jnp.complex128)
    recon = jnp.einsum("np,up->un", rep.ad, rep.z) * np.sqrt(CFG.nt * CFG.nr)
    np.testing.assert_allclose(np.asarray(recon), np.asarray(ch.vec_h),
                               atol=1e-9)


def test_angle_dictionary_shape():
    ad = angle_dictionary(CFG, 95.0)
    # FoV window restricts the 32x32 grid
    assert ad.shape[0] == 64
    assert 0 < ad.shape[1] < 32 * 32
    # unit-modulus columns scaled by 1/sqrt(Nt*Nr)
    np.testing.assert_allclose(np.abs(np.asarray(ad)),
                               1.0 / np.sqrt(64), rtol=1e-6)


def test_measurement_noiseless_matches_matmul(key):
    ch = generate_channel(key, CFG, CH, batch=2, dtype=jnp.complex128)
    fw = jax.random.normal(jax.random.fold_in(key, 7), (10, 64)) \
        .astype(jnp.complex128)
    meas = generate_measurement(key, fw, ch.vec_h, snr_db=20.0,
                                add_noise=False)
    expect = np.abs(np.asarray(ch.vec_h) @ np.asarray(fw).T) ** 2
    np.testing.assert_allclose(np.asarray(meas.norm_square), expect,
                               rtol=1e-10)


def test_measurement_snr_scaling(key):
    ch = generate_channel(key, CFG, CH, batch=1)
    n = CFG.n
    fw = jnp.ones((2000, n), jnp.complex64) / n
    hi = generate_measurement(key, fw, ch.vec_h, snr_db=40.0)
    lo = generate_measurement(key, fw, ch.vec_h, snr_db=0.0)
    clean = np.abs(np.asarray(ch.vec_h) @ np.asarray(fw).T) ** 2
    err_hi = np.mean(np.abs(np.asarray(hi.norm_square) - clean))
    err_lo = np.mean(np.abs(np.asarray(lo.norm_square) - clean))
    assert err_hi < err_lo


def test_colored_noise_tiles_across_tx(key):
    # With (W, mt) given, noise realization repeats across Tx probes
    # (ref: Generate_Measurement.m:110-115).
    vec_h = jnp.zeros((1, CFG.n), jnp.complex64)
    mt, mr = 3, 4
    f = jnp.ones((CFG.nt, mt), jnp.complex64) / np.sqrt(CFG.nt)
    w = jnp.ones((1, CFG.nr, mr), jnp.complex64) / np.sqrt(CFG.nr)
    fw = jnp.zeros((mt * mr, CFG.n), jnp.complex64)
    meas = generate_measurement(key, fw, vec_h, snr_db=0.0, w=w, mt=mt)
    y = np.asarray(meas.perfect_phase)[0].reshape(mt, mr)
    np.testing.assert_allclose(y[0], y[1])
    np.testing.assert_allclose(y[0], y[2])


def test_unit_chain_roundtrip():
    rss_dbm = jnp.array([-50.0, -62.3, -74.0])
    amp = dbm_to_amplitude(rss_dbm)
    np.testing.assert_allclose(np.asarray(amplitude_to_dbm(amp)),
                               np.asarray(rss_dbm), rtol=1e-6)
