"""Tests for beam sweeping (E5), spectral-profile analysis (E6), antenna
grouping/calibration (H4/H5)."""

import numpy as np
import jax
import jax.numpy as jnp

from twoace.config import ArrayConfig, ChannelConfig
from twoace.models import generate_channel
from twoace.ops.beamsweep import sweep_channel
from twoace.sensing.grouping import (
    antenna_phase_shifts,
    group_antennas,
    ideal_steering_ura,
    ura_coordinates,
)
from twoace.utils.spectral_analysis import (
    captured_energy,
    eig_decay,
    ladder_deviation,
    nuclear_norm,
    power_law_fit,
)

CFG = ArrayConfig(nt=8, nr=8)


def test_beam_sweep_finds_dominant_path(key):
    ch = generate_channel(key, CFG,
                          ChannelConfig(n_paths=1, rician_k=0), batch=1,
                          dtype=jnp.complex128)
    res = sweep_channel(key, ch.vec_h[0], CFG, mt=16, mr=16,
                        aod_range=(-47.5, 47.5), aoa_range=(-47.5, 47.5))
    # refined angle within one sector width (95/16 ~ 6 deg) of the truth
    assert abs(float(res.aod_deg) - float(ch.aod_deg[0, 0])) < 6.0
    assert abs(float(res.aoa_deg) - float(ch.aoa_deg[0, 0])) < 6.0


def test_captured_energy_and_ladder(key):
    ch = generate_channel(key, CFG, ChannelConfig(n_paths=2, rician_k=0),
                          batch=3, dtype=jnp.complex128)
    frac = captured_energy(ch.h_matrix)
    assert frac.shape == (3, 8)
    np.testing.assert_allclose(np.asarray(frac[:, -1]), 1.0, rtol=1e-6)
    # 2-path channel: rank 2 captures everything
    np.testing.assert_allclose(np.asarray(frac[:, 1]), 1.0, rtol=1e-6)
    dev = ladder_deviation(ch.h_matrix, CFG.nt, CFG.nr)
    for v in dev.values():
        np.testing.assert_allclose(np.asarray(v), 0.0, atol=1e-9)
    # iid random matrix violates the ladder
    g = jax.random.normal(key, (8, 8))
    dev2 = ladder_deviation(g + 0j, 8, 8)
    assert max(float(jnp.max(v)) for v in dev2.values()) > 0.05


def test_eig_decay_and_norms(key):
    ch = generate_channel(key, CFG, ChannelConfig(n_paths=1, rician_k=0),
                          batch=1, dtype=jnp.complex128)
    d = eig_decay(ch.h_matrix)
    assert float(d[0, 0]) == 1.0 and float(d[0, 1]) < 1e-8
    assert float(nuclear_norm(ch.h_matrix)[0]) > 0
    alpha, resid = power_law_fit(ch.h_matrix)
    assert np.isfinite(float(alpha[0]))


def test_group_antennas_respects_phase_alignment():
    # two clusters of antennas with offsets ~0 and ~pi: groups of 2 should
    # pair same-cluster antennas (zero-cost alignment) first
    offsets = np.array([0.0, 0.02, np.pi, np.pi + 0.01, 0.01, np.pi - 0.02,
                        0.0, np.pi])
    coords = np.zeros((8, 2))   # colocated -> pure hardware phase decides
    groups, calib = group_antennas(offsets, group_size=2, coords=coords)
    assert len(groups) == 4
    for g in groups:
        diff = abs(offsets[g[0]] - offsets[g[1]]) % (2 * np.pi)
        diff = min(diff, 2 * np.pi - diff)
        # grouped phases are 2-bit representable relative to each other
        assert min(diff % (np.pi / 2), np.pi / 2 - diff % (np.pi / 2)) < 0.05
    assert calib.shape == (8,)


def test_antenna_phase_shift_recovery():
    # synthetic: measured steering = ideal * per-antenna offset
    rng = np.random.default_rng(0)
    coords = ura_coordinates(16)
    ideal = ideal_steering_ura(np.linspace(-45, 45, 9),
                               np.linspace(-20, 20, 5), coords)
    true_off = rng.uniform(-np.pi, np.pi, 16)
    measured_phase = np.angle(ideal) + true_off[:, None, None]
    est = antenna_phase_shifts(measured_phase, ideal)
    err = np.angle(np.exp(1j * (est - true_off)))
    np.testing.assert_allclose(err, 0.0, atol=1e-8)


def test_subset_sweep_rss_monotone(key):
    """Larger sweep subsets find better beams on average
    (ref show_beamforming_data.m:42-49)."""
    from twoace.ops.beamsweep import aggregate_beamforming, subset_sweep_rss

    rng = np.random.default_rng(0)
    grid = jnp.asarray(rng.normal(size=(16, 16)) * 3 - 60)
    small = float(subset_sweep_rss(key, grid, 2, n_runs=500))
    large = float(subset_sweep_rss(key, grid, 12, n_runs=500))
    full = float(jnp.max(grid))
    assert small < large <= full + 1e-6

    agg = aggregate_beamforming(
        {"a2": np.asarray([-60.0, -55.0])}, rss_sweep_phi=grid,
        m_grid=[2, 12], key=key, n_runs=200)
    assert agg["a2"].shape == (2,)
    assert agg["sweep_phi"][0] < agg["sweep_phi"][1]
