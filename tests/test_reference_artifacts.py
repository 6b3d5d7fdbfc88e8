"""Validation against the reference's SHIPPED real-hardware .mat artifacts.

The reference ships the actual measured-testbed codebooks and calibration
data used in the MobiHoc '23 experiments:

  - codebook/codebook_mat/random_probe_cb_16x16.mat           (3968 x 256)
  - codebook/codebook_mat/random_probe_cb_16x16_multires.mat  (9920 x 256)
  - codebook/codebook_mat/random_probe_cb_16x16_multires_actual.mat
  - codebook/hardware_phaseoffset.mat                          (32 offsets)
  - codebook/directional_codebook_generator/steering_vector_calib.mat
  - the txt phase tables under codebook/codebook_brd/*_16ant_*/

These are the only real-hardware ground truth available in this
environment.  The tests below pin the repo's codebook semantics against
them:

  - kron row assembly + row ORDERING (processsing_codebook_random.m:54-62
    non-permuted reshape vs processsing_codebook_multires.m:60-61
    permute([2,1,3]) reshape) reproduced by
    :func:`twoace.sensing.codebooks.kron_probe_rows`;
  - the calibration-bit fold relating the "_multires_actual" matrix to the
    "_multires" (inferred) one (generate_rx_codebook_multires_16ant.py:84-115:
    actual_bit = (ideal - calib) mod 4 on tiers 1-2, identity on tier 3,
    applied on BOTH the Tx and Rx factor);
  - the hardware grouping/tier structure of the shipped multires tables;
  - the per-antenna phase-offset derivation
    (AntennaPhaseShifts.m + IdealSteeringVectorPerPanel.m) reproducing
    hardware_phaseoffset.mat from steering_vector_calib.mat exactly;
  - one end-to-end A2 recovery through the real random probe rows.
"""

import os

import numpy as np
import pytest

REF = "/root/reference/codebook"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference artifacts not mounted")

scipy_io = pytest.importorskip("scipy.io")

#: active antennas of the 16-of-32 testbed panel, 0-based
#: (ref: processsing_codebook_random.m "id = [1..8, 17..24]")
ACTIVE_16 = np.array([1, 2, 3, 4, 5, 6, 7, 8,
                      17, 18, 19, 20, 21, 22, 23, 24]) - 1
#: full 32-antenna calibration-bit table
#: (ref: generate_rx_codebook_multires_16ant.py:49-50)
CALIB_32 = np.array([0, 2, 3, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0,
                     1, 0, 0, 3, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0])

SECTORS = 62          #: Tx sectors per probing round (ref: main/main.py:241)
MULTIRES_ROUNDS = 160
RANDOM_ROUNDS = 64
TIER_ROUNDS = (32, 96, 160)   #: tier boundaries in rounds (separation[.]=32/96/160)


def _load_cb(name):
    return scipy_io.loadmat(os.path.join(REF, "codebook_mat", name))["cb"]


def _read_phase_txt(path, skip_zero_pad=False):
    """Parse a .brd txt phase table (one 32-digit row per line).

    ``skip_zero_pad`` drops the all-zero padding rows the processing
    scripts skip at positions 1-2 of every 64-line Tx block
    (ref: processsing_codebook_random.m tx read loop).
    """
    rows, counter = [], 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            counter += 1
            bits = np.array([int(c) for c in line], np.int64)
            if skip_zero_pad and not bits.any() and counter % 64 in (1, 2):
                continue
            rows.append(bits)
    return np.stack(rows)


def _rows_from_txt(kind):
    """(tx_rows (rounds, 62, 16), rx_rows (rounds, 16)) complex factors."""
    sub = {"random": ("random_16ant_rx/random_codebook_16ant_rx.txt",
                      "random_16ant_tx/random_codebook_16ant_tx.txt"),
           "multires": ("multires_16ant_rx/multires_16_rx.txt",
                        "multires_16ant_tx/multires_16_tx.txt")}[kind]
    rx_bits = _read_phase_txt(os.path.join(REF, "codebook_brd", sub[0]))
    tx_bits = _read_phase_txt(os.path.join(REF, "codebook_brd", sub[1]),
                              skip_zero_pad=True)
    rx = np.exp(1j * (np.pi / 2) * rx_bits[:, ACTIVE_16])
    tx = np.exp(1j * (np.pi / 2) * tx_bits[:, ACTIVE_16])
    rounds = rx.shape[0]
    return tx.reshape(rounds, SECTORS, 16), rx


def test_shipped_random_cb_is_2bit_kron():
    """Every shipped probe row is a unit-modulus 2-bit kron(tx, rx) row."""
    cb = _load_cb("random_probe_cb_16x16.mat")
    assert cb.shape == (RANDOM_ROUNDS * SECTORS, 256)
    np.testing.assert_allclose(np.abs(cb), 1.0, atol=1e-12)
    ph = np.angle(cb) / (np.pi / 2)
    np.testing.assert_allclose(ph, np.round(ph), atol=1e-9)
    # kron structure: reshape(row, 16, 16) is rank 1
    for i in (0, 1234, 3967):
        s = np.linalg.svd(cb[i].reshape(16, 16), compute_uv=False)
        assert s[1] / s[0] < 1e-12


def test_kron_probe_rows_reproduces_shipped_random_cb():
    """kron_probe_rows(interleave=True) == the shipped random_probe_cb
    (round-fastest ordering: flat = round + 64*sector, the column-major
    reshape of processsing_codebook_random.m without permute)."""
    from twoace.sensing.codebooks import kron_probe_rows

    tx, rx = _rows_from_txt("random")
    cb = _load_cb("random_probe_cb_16x16.mat")
    rows = np.asarray(kron_probe_rows(tx, rx, interleave=True))
    np.testing.assert_allclose(rows, cb, atol=1e-12)


def test_kron_probe_rows_reproduces_shipped_multires_cb():
    """kron_probe_rows(interleave=False) == the shipped multires cb
    (sector-fastest ordering: flat = sector + 62*round, MATLAB's
    permute([2,1,3]) + reshape, processsing_codebook_multires.m:60-61).
    Resolution tiers are then CONTIGUOUS row ranges — the precondition of
    the tier-aware sampling (..._multiresolution.m:111-112,137-143 and
    pipeline/recovery._pick_m_indices)."""
    from twoace.sensing.codebooks import kron_probe_rows

    tx, rx = _rows_from_txt("multires")
    cb = _load_cb("random_probe_cb_16x16_multires.mat")
    rows = np.asarray(kron_probe_rows(tx, rx, interleave=False))
    np.testing.assert_allclose(rows, cb, atol=1e-12)
    # tier-1 rows are exactly [0, 62*32)
    r_round = np.arange(cb.shape[0]) // SECTORS
    assert (r_round < TIER_ROUNDS[0]).sum() == 1984


def test_multires_actual_is_calibration_fold_of_inferred():
    """_multires_actual = _multires * kron(calib_tx, calib_rx) phase fold on
    tiers 1-2; identical on tier 3 (full-resolution codebooks bake no
    calibration, generate_rx_codebook_multires_16ant.py:106-115)."""
    cb_inf = _load_cb("random_probe_cb_16x16_multires.mat")
    cb_act = _load_cb("random_probe_cb_16x16_multires_actual.mat")
    from twoace.sensing.codebooks import REFERENCE_CALIBRATION_16

    np.testing.assert_array_equal(REFERENCE_CALIBRATION_16,
                                  CALIB_32[ACTIVE_16])
    fac = np.exp(-1j * (np.pi / 2) * REFERENCE_CALIBRATION_16)
    full_fac = np.kron(fac, fac)                       # tx ⊗ rx
    r_round = np.arange(cb_inf.shape[0]) // SECTORS
    t12 = r_round < TIER_ROUNDS[1]
    np.testing.assert_allclose(cb_inf[t12] * full_fac[None, :],
                               cb_act[t12], atol=1e-12)
    np.testing.assert_allclose(cb_inf[~t12], cb_act[~t12], atol=0)


def test_multires_codebook_calibration_semantics_match_shipped():
    """The repo's multires generator folds calibration exactly like the
    shipped tables: actual_bit = (ideal - calib) mod 4
    (generate_rx_codebook_multires_16ant.py:84-87)."""
    rx_i = _read_phase_txt(os.path.join(
        REF, "codebook_brd", "multires_16ant_rx/multires_16_rx.txt"))
    rx_a = _read_phase_txt(os.path.join(
        REF, "codebook_brd", "multires_16ant_rx/multires_16_rx_actual.txt"))
    d = (rx_i - rx_a)[:, ACTIVE_16] % 4
    np.testing.assert_array_equal(d[:96], np.tile(CALIB_32[ACTIVE_16],
                                                  (96, 1)))
    assert not d[96:].any()

    # same fold applied through the repo generator
    import jax
    from twoace.sensing.codebooks import (REFERENCE_CALIBRATION_16,
                                              multires_codebook)

    inf, act = multires_codebook(jax.random.PRNGKey(0), 16,
                                 calibration=REFERENCE_CALIBRATION_16)
    np.testing.assert_array_equal(
        (np.asarray(inf.bits) - np.asarray(act.bits)) % 4,
        np.tile(REFERENCE_CALIBRATION_16, (160, 1)))


def test_shipped_multires_tier_grouping():
    """Tier structure of the shipped (inferred) multires Rx table: tier-1
    rounds share one phase bit per hardware 4-group, tier-2 per 2-group,
    tier-3 independent (grouping table,
    generate_rx_codebook_multires_16ant.py:48)."""
    rx_i = _read_phase_txt(os.path.join(
        REF, "codebook_brd", "multires_16ant_rx/multires_16_rx.txt"))
    g4 = [[1, 2, 3, 4], [5, 6, 7, 8], [17, 18, 19, 20], [21, 22, 23, 24]]
    g2 = [[1, 2], [3, 4], [5, 7], [6, 8], [17, 18], [19, 20],
          [21, 23], [22, 24]]
    for g in g4:
        idx = np.array(g) - 1
        assert (rx_i[:32][:, idx] == rx_i[:32][:, idx[:1]]).all()
    for g in g2:
        idx = np.array(g) - 1
        assert (rx_i[32:96][:, idx] == rx_i[32:96][:, idx[:1]]).all()
    # tier 3: at least one pair disagrees somewhere
    assert (rx_i[96:, 0] != rx_i[96:, 1]).any()


def test_hardware_phaseoffset_reproduced_from_calib_sweep():
    """per_panel_phase_offsets reproduces the shipped
    hardware_phaseoffset.mat from steering_vector_calib.mat to machine
    precision (ref: AntennaPhaseShifts.m:3-8,
    IdealSteeringVectorPerPanel.m:9-41)."""
    from twoace.sensing.grouping import per_panel_phase_offsets

    d = scipy_io.loadmat(os.path.join(
        REF, "directional_codebook_generator/steering_vector_calib.mat"))
    hw = scipy_io.loadmat(os.path.join(
        REF, "hardware_phaseoffset.mat"))["antenna_phase_shifts"].ravel()
    aps = per_panel_phase_offsets(
        d["steering_phase"], d["azim_range"].ravel(),
        d["elev_range"].ravel(), d["beam_map"].ravel())
    err = np.abs(np.angle(np.exp(1j * (aps - hw))))
    assert err.max() < 1e-12


def test_recovery_through_shipped_random_codebook():
    """End-to-end A2 recovery of a synthetic 16x16 channel measured through
    the REAL testbed probe rows (the shipped random_probe_cb), M = 529
    (the 6th point of the reference M grid, A2only.m:110-111).

    The shipped rows are rank-1 kron(tx, rx) probes — a strictly harder
    sensing ensemble than iid random rows: the same channel/solver at
    M = 225 fails the held-out quality gate (q = 0.53 < 0.6) while
    M = 529 recovers to -55 dB and M = 1024 to -104 dB (measured on this
    exact configuration; the reference likewise operates these codebooks
    at the upper end of its M grid for accurate recovery)."""
    import jax
    import jax.numpy as jnp

    from twoace.config import AdmmConfig, ArrayConfig, ChannelConfig
    from twoace.models.channel import generate_channel
    from twoace.ops.admm import solve_lowrank_multi

    cb = _load_cb("random_probe_cb_16x16.mat")
    rng = np.random.default_rng(2023)
    rows = cb[rng.permutation(cb.shape[0])[:529]] / np.sqrt(256.0)

    cfg = ArrayConfig(nt=16, nr=16)
    ch = generate_channel(jax.random.PRNGKey(11), cfg,
                          ChannelConfig(n_paths=2), batch=1)
    vec_h = np.asarray(ch.vec_h[0])
    b = np.abs(rows @ vec_h)

    res = solve_lowrank_multi(jax.random.PRNGKey(0),
                              jnp.asarray(rows), jnp.asarray(b),
                              16, 16, AdmmConfig(maxiter=500))
    x = np.asarray(res.x)
    assert float(res.quality) > 0.9
    c = np.vdot(x, vec_h) / max(np.vdot(x, x).real, 1e-30)
    nmse_db = 10 * np.log10(np.linalg.norm(vec_h - c * x) ** 2
                            / np.linalg.norm(vec_h) ** 2)
    assert nmse_db < -30.0, f"NMSE through real codebook: {nmse_db:.1f} dB"
