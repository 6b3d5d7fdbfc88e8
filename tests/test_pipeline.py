"""End-to-end pipeline tests: testbed campaigns, recovery entries, mobility,
simulation sweeps (SURVEY §2.5/§3.1/§3.5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import (
    AdmmConfig,
    ArrayConfig,
    ChannelConfig,
    MethodFlags,
)
from twoace.models import generate_channel
from twoace.pipeline import (
    CampaignConfig,
    MobilityConfig,
    SimulationConfig,
    TestbedConfig,
    TestbedRunner,
    recover_a2only,
    sweep_measurements,
    track,
)
from twoace.sensing.codebooks import random_codebook, kron_probe_rows
from twoace.sensing.provider import (
    RetryingProvider,
    SyntheticProvider,
    ThermalGuard,
)
from twoace.utils.checkpoint import CampaignStore
from twoace.utils.metrics import nmse_h_projection
from twoace.utils.units import dbm_to_amplitude


CFG = ArrayConfig(nt=4, nr=4)
FAST_ADMM = AdmmConfig(maxiter=150, n_restarts=1)


def _ground_truth(key, cfg=CFG):
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=2, rician_k=0),
                          batch=1, dtype=jnp.complex128)
    return ch


def test_synthetic_provider_chain(key):
    ch = _ground_truth(key)
    prov = SyntheticProvider(vec_h=ch.vec_h[0] * 1e-2, noise_dbm_std=0.0)
    rows = jnp.eye(CFG.n, dtype=jnp.complex128)[:4]
    rss = prov.measure(rows)
    expect = 10 * np.log10(np.abs(np.asarray(ch.vec_h[0][:4]) * 1e-2) ** 2)
    # RSSI quantization limits agreement to the 0.0652 dB step
    np.testing.assert_allclose(rss, expect, atol=0.04)


def test_retry_ladder_recovers_and_escalates(key):
    ch = _ground_truth(key)
    flaky = SyntheticProvider(vec_h=ch.vec_h[0], fail_rate=1.0)
    resets = []
    prov = RetryingProvider(flaky, max_retries=3,
                            reset_hook=lambda: resets.append(1))
    with pytest.raises(RuntimeError):
        prov.measure(jnp.eye(CFG.n, dtype=jnp.complex128)[:2])
    assert len(resets) == 3


def test_thermal_guard_waits():
    temps = iter([(80.0, 60.0), (75.0, 60.0), (60.0, 50.0)])
    sleeps = []
    guard = ThermalGuard(read_temps=lambda: next(temps),
                         sleep_fn=lambda s: sleeps.append(s))
    waits = guard.wait_until_cool()
    assert waits == 2 and sleeps == [20.0, 20.0]


def test_testbed_campaign_and_recovery(key, tmp_path):
    """Full synthetic testbed flow: random campaign -> A2 recovery -> NMSE."""
    ch = _ground_truth(key)
    prov = SyntheticProvider(vec_h=ch.vec_h[0] * 3e-4, noise_dbm_std=0.0)
    tb_cfg = TestbedConfig(array=CFG, n_random_rounds=8, sectors_per_round=8,
                           checkpoint_dir=str(tmp_path))
    runner = TestbedRunner(tb_cfg, prov, key=key)
    runner.run_random_campaign()
    data = runner.results["random"]
    assert data["rows"].shape == (64, CFG.n)

    out = runner.estimate("random", "a2only", seed_id=1,
                          cc=CampaignConfig(array=CFG, admm=FAST_ADMM,
                                            n_paths=2))
    assert out.h_amp.shape[0] == len(out.m_grid)
    # best-M estimate should correlate with the ground truth
    h_est = out.h_amp[-1, 0] * np.exp(1j * out.h_angle[-1, 0])
    nmse = float(nmse_h_projection(jnp.asarray(h_est)[None],
                                   ch.vec_h * 3e-4)[0])
    assert nmse < 0.3, nmse
    # checkpoints were written and enable resume
    store = CampaignStore(str(tmp_path))
    assert len(store.completed_rounds("random")) == 8


def test_testbed_resume_skips_measured_rounds(key, tmp_path):
    ch = _ground_truth(key)
    prov = SyntheticProvider(vec_h=ch.vec_h[0], noise_dbm_std=0.0)
    tb_cfg = TestbedConfig(array=CFG, n_random_rounds=4, sectors_per_round=4,
                           checkpoint_dir=str(tmp_path))
    r1 = TestbedRunner(tb_cfg, prov, key=key)
    r1.run_random_campaign()
    calls_after_first = prov._calls
    # second runner resumes: no new provider calls
    r2 = TestbedRunner(tb_cfg, prov, key=key)
    r2.run_random_campaign()
    assert prov._calls == calls_after_first
    np.testing.assert_allclose(r2.results["random"]["rss_dbm"],
                               r1.results["random"]["rss_dbm"])


def test_beamforming_comparison_beats_noise(key):
    ch = _ground_truth(key)
    prov = SyntheticProvider(vec_h=ch.vec_h[0], noise_dbm_std=0.0)
    runner = TestbedRunner(TestbedConfig(array=CFG), prov, key=key)
    rss = runner.beamforming_comparison({
        "truth": np.asarray(ch.vec_h[0]),
        "garbage": np.ones(CFG.n, complex),
    })
    assert rss["truth"] >= rss["garbage"] - 1e-6


def test_mobility_tracking_adapts(key):
    """Static channel: once locked, rss error stays low; budget resets to 0."""
    ch = _ground_truth(key)
    t_size, n_windows = 16, 6
    cb = random_codebook(key, t_size * n_windows, CFG.n).rows(normalize=True)
    amps = jnp.abs(cb @ ch.vec_h[0])
    trace = track(key, cb, amps, CFG,
                  MobilityConfig(window_probes=t_size, max_window=48,
                                 admm=FAST_ADMM))
    assert trace.rss_error.shape == (n_windows,)
    # once the sliding window holds ~3n probes the estimate locks in and
    # predicts future RSS well; the budget then resets to zero
    assert trace.rss_error[3:].max() < 0.3
    assert trace.probe_budget[4:].max() == 0


def test_simulation_sweep_runs(key):
    sim = SimulationConfig(
        array=ArrayConfig(nt=4, nr=4),
        channel=ChannelConfig(n_paths=1, rician_k=0, on_grid=True),
        snr_db=20.0,
        methods=MethodFlags(admm_lowrank_v4=False, plomp=True, plgamp=False),
        n_trials=2)
    res = sweep_measurements(key, [4, 6], sim, searching_area=60.0)
    assert "plomp" in res.nmse
    assert res.nmse["plomp"].shape == (2,)
    assert np.isfinite(res.nmse["plomp"]).all()
    # perfect/noisy-phase CS baselines ride along (ref Vs_M method set)
    assert "perfect_phase_cs" in res.nmse


def test_h_domain_angle_readout(key):
    """H-domain solvers get finite AoD/AoA via the dictionary projection
    (metrics.sparse_projection_omp): an on-grid 1-path channel's exact
    vec_h must project to its own support, giving ~0 angle error."""
    import jax.numpy as jnp

    from twoace.models import generate_channel, sparse_formulation
    from twoace.utils.metrics import (angle_error, angles_from_sparse,
                                          sparse_projection_omp)

    cfg = ArrayConfig(nt=4, nr=4)
    ch = generate_channel(key, cfg,
                          ChannelConfig(n_paths=1, rician_k=0, on_grid=True),
                          batch=3)
    rep = sparse_formulation(cfg, ch, 90.0)
    z = jax.vmap(lambda h: sparse_projection_omp(h, rep.ad, 1))(
        jnp.asarray(ch.vec_h))
    aod, aoa = angles_from_sparse(z, cfg, rep.tx_window, rep.rx_window, 1)
    ang = angle_error(aod, aoa, ch.aod_deg, ch.aoa_deg)
    # on-grid angles land exactly on dictionary columns
    assert float(jnp.max(ang.aoda_err)) < 1.5


def test_simulated_mobility_budget_rule(key):
    """track_simulated: budget shrinks by floor(M/5)+1 on success, grows on
    failure (ref RSS_Mobility_simu.m:155-160); static channel locks in."""
    from twoace.pipeline import SimulatedMobilityConfig, track_simulated

    ch = _ground_truth(key)
    p, n_windows = 24, 6
    cb = random_codebook(key, p * n_windows, CFG.n).rows(normalize=True)
    amps = jnp.abs(cb @ ch.vec_h[0])
    mob = SimulatedMobilityConfig(window_probes=p, max_window=96,
                                  m_init=20, m_max=20, threshold=0.3,
                                  admm=FAST_ADMM)
    trace = track_simulated(key, cb, amps, CFG, mob)
    assert trace.probe_budget[0] == 20
    for t in range(1, n_windows):
        prev = trace.probe_budget[t - 1]
        if trace.rss_error[t - 1] < mob.threshold:
            assert trace.probe_budget[t] == max(0, prev - prev // 5 - 1)
        else:
            assert trace.probe_budget[t] == min(mob.m_max, prev + prev // 5 + 1)
    # a static channel eventually predicts held-out RSS well
    assert trace.rss_error[3:].min() < 0.3


def test_brownian_trace_shapes(key):
    from twoace.pipeline import SimulatedMobilityConfig, brownian_trace

    mob = SimulatedMobilityConfig(window_probes=10)
    cb, rss, vec_h = brownian_trace(key, CFG, mob, n_windows=4)
    assert cb.shape == (40, CFG.n)
    assert rss.shape == (40,)
    assert vec_h.shape == (4, CFG.n)
    # every probe's RSS is |row . vec_h| of its window's channel
    np.testing.assert_allclose(
        np.asarray(rss[:10]), np.abs(np.asarray(cb[:10]) @ np.asarray(vec_h[0])),
        rtol=1e-5)


def test_trace_sweep_wireless_insite(key):
    """sweep_measurements_trace: unit-magnitude normalized trace channels
    (ref Vs_M_Wireless_Insite.m:167-172) through the standard cell."""
    from twoace.pipeline import sweep_measurements_trace

    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 4, 4)) + 1j * rng.normal(size=(2, 4, 4))
    sim = SimulationConfig(
        array=CFG,
        channel=ChannelConfig(n_paths=1, rician_k=0),
        snr_db=20.0,
        methods=MethodFlags(admm_lowrank_v4=True, plomp=False, plgamp=False),
        admm=FAST_ADMM)
    res = sweep_measurements_trace(key, h, [12], sim, searching_area=90.0)
    assert "admm_lowrank_v4" in res.nmse
    assert np.isfinite(res.nmse["admm_lowrank_v4"]).all()
    # the A2 estimate of a unit-modulus channel should carry signal
    assert res.nmse["admm_lowrank_v4"][0] < 1.0


def test_directional_campaign_and_aco(key):
    """Campaign 3 + ACO: the ACO-calibrated beam pair should beat a random
    2-bit beam pair on the same channel (ref main.py:183-220, 398-419)."""
    from twoace.sensing.codebooks import kron_probe_rows as kpr

    ch = _ground_truth(key)
    prov = SyntheticProvider(vec_h=ch.vec_h[0], noise_dbm_std=0.0)
    runner = TestbedRunner(TestbedConfig(array=CFG, n_directional=6), prov,
                           key=key)
    runner.run_directional_campaign()
    assert runner.results["directional"]["rss_dbm"].shape == (36,)

    wt_aco, wr_aco = runner.collect_aco()
    assert wt_aco.shape == (CFG.nt,) and wr_aco.shape == (CFG.nr,)
    step = 2 * np.pi / 4
    wt = jnp.exp(1j * wt_aco * step) / np.sqrt(CFG.nt)
    wr = jnp.exp(1j * wr_aco * step) / np.sqrt(CFG.nr)
    aco_rss = prov.measure(kpr(wt[None, None, :], wr[None, :]))[0]
    rng = np.random.default_rng(0)
    rnd_rss = []
    for _ in range(8):
        bt = jnp.asarray(rng.integers(0, 4, CFG.nt))
        br = jnp.asarray(rng.integers(0, 4, CFG.nr))
        w1 = jnp.exp(1j * bt * step) / np.sqrt(CFG.nt)
        w2 = jnp.exp(1j * br * step) / np.sqrt(CFG.nr)
        rnd_rss.append(prov.measure(
            kpr(w1[None, None, :], w2[None, :]))[0])
    assert aco_rss > np.mean(rnd_rss)


def test_evaluation_codebook_rss(key):
    """codebook_generator equivalent: per-method SVD beams + ACO + probe
    sectors, measured in one go (ref codebook_library.py:192-451)."""
    ch = _ground_truth(key)
    # 3e-4 amplitude scale keeps the synthetic RSSI word off its clip
    prov = SyntheticProvider(vec_h=ch.vec_h[0] * 3e-4, noise_dbm_std=0.0)
    runner = TestbedRunner(TestbedConfig(array=CFG), prov, key=key)
    h_est = np.stack([np.asarray(ch.vec_h[0])] * 2)
    rss, txb, rxb = runner.evaluate_codebook_rss(
        h_est, h_directional=ch.vec_h[0],
        aco_bits=(jnp.zeros(CFG.nt, jnp.int32), jnp.zeros(CFG.nr, jnp.int32)),
        n_probe=5)
    # 2 estimates + 1 directional + 1 ACO + 5 probes
    assert rss.shape == (9,) and txb.shape == (9, CFG.nt)
    # the SVD beam of the true channel should beat the random probe sectors
    assert rss[0] > np.mean(rss[-5:])


def test_warm_sweep_coarse_to_fine():
    """Warm-started M-sweep: later (finer) budgets reuse earlier solutions
    and must reach strong recovery at the full budget."""
    import numpy as np
    from twoace.config import AdmmConfig, ArrayConfig
    from twoace.pipeline.recovery import CampaignConfig, recover_warm_sweep
    from twoace.utils.units import amplitude_to_dbm

    cfg = ArrayConfig(nt=4, nr=4)
    n = cfg.n
    rng = np.random.default_rng(0)
    total = 4 * n
    bits = rng.integers(0, 4, (total, n))
    cb = np.exp(1j * bits * np.pi / 2) / np.sqrt(n)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    h = sum((rng.normal() + 1j * rng.normal())
            * np.outer(steer(4, a1), steer(4, a2).conj())
            for a1, a2 in [(0.3, -0.5), (0.9, 0.2)])
    x_true = h.T.reshape(-1)
    rss_fct = 1e5 / 3
    dbm = np.asarray(amplitude_to_dbm(jnp.asarray(np.abs(cb @ x_true)),
                                      rss_fct))
    cc = CampaignConfig(array=cfg, rss_fct=rss_fct,
                        admm=AdmmConfig(maxiter=120))
    out, quals = recover_warm_sweep(cb, dbm, cc=cc, m_grid=(24, 48, 64))
    x = out.h_amp[-1, 0] * np.exp(1j * out.h_angle[-1, 0])
    c = np.vdot(x, x_true) / max(np.vdot(x, x).real, 1e-30)
    nmse = (np.linalg.norm(x_true - c * x) ** 2
            / np.linalg.norm(x_true) ** 2)
    assert 10 * np.log10(max(nmse, 1e-30)) < -25
    assert quals[-1] > 0.95


def test_anchored_refine_preserves_unmeasured_directions():
    """The proximal anchor (refine_lowrank_pair anchor_weight): directions
    the measurement rows do not constrain must stay at the previous
    estimate instead of drifting — the mechanism letting the mobility
    tracker accumulate Rx-sector diversity across kron-probed windows
    (ref probing structure: RSS_Mobility.m cb = kron(rx_cb, tx_cb))."""
    import jax.numpy as jnp

    from twoace.config import AdmmConfig
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import refine_lowrank_pair

    nt = nr = 4
    n = nt * nr
    rng = np.random.default_rng(0)

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    vh = (1.3 * np.exp(0.4j)
          * np.outer(steer(nr, 0.5), steer(nt, -0.3).conj())).T.reshape(-1)
    # ONE rx sector x 12 tx sectors: constrains only 1 scalar of the rx side
    w = np.exp(1j * rng.integers(0, 4, nr) * (np.pi / 2)) / np.sqrt(nr)
    rows = np.stack([np.kron(
        np.exp(1j * rng.integers(0, 4, nt) * (np.pi / 2)) / np.sqrt(nt), w)
        for _ in range(12)])
    b = jnp.asarray(np.abs(rows @ vh), jnp.float32)
    ap = Pair(jnp.asarray(rows.real, jnp.float32),
              jnp.asarray(rows.imag, jnp.float32))
    x0 = Pair(jnp.asarray(vh.real, jnp.float32),
              jnp.asarray(vh.imag, jnp.float32))   # anchor = truth

    cfg = AdmmConfig(maxiter=150)
    res_a = refine_lowrank_pair(ap, b, x0, nt, nr, cfg, use_rank_one=True,
                                anchor_weight=3.0)
    xa = np.asarray(res_a.x.re) + 1j * np.asarray(res_a.x.im)

    def dist(x):
        c = np.vdot(x, vh) / max(np.vdot(x, x).real, 1e-30)
        return np.linalg.norm(vh - c * x) / np.linalg.norm(vh)

    # anchored at the truth, the under-determined solve must stay there
    assert dist(xa) < 0.15, dist(xa)
    assert float(res_a.quality) > 0.8


def test_warm_tracking_solver_runs_and_resets(key):
    """make_warm_pair_solver end-to-end through track() on a tiny kron
    workload: runs, produces finite estimates, and its reset() clears the
    carried state."""
    from twoace.config import AdmmConfig
    from twoace.pipeline.mobility import (MobilityConfig,
                                              make_warm_pair_solver, track)

    nt = nr = 4
    rng = np.random.default_rng(1)
    p, t_w = 10, 4

    def steer(nn, ang):
        return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)

    vh = (np.outer(steer(nr, 0.2), steer(nt, -0.5).conj())).T.reshape(-1)
    rows = []
    for t in range(t_w):
        w = np.exp(1j * rng.integers(0, 4, nr) * (np.pi / 2)) / np.sqrt(nr)
        for _ in range(p):
            f = np.exp(1j * rng.integers(0, 4, nt) * (np.pi / 2)) / np.sqrt(nt)
            rows.append(np.kron(f, w))
    rows = np.stack(rows).astype(np.complex64)
    amps = np.abs(rows @ vh).astype(np.float32)

    admm = AdmmConfig(maxiter=100)
    mob = MobilityConfig(window_probes=p, max_window=16, admm=admm)
    solver = make_warm_pair_solver(
        t2_cfg(nt, nr), admm, use_rank_one=True)
    trace = track(key, rows, amps, t2_cfg(nt, nr), mob, solver=solver,
                  static_pad=True)
    assert np.all(np.isfinite(trace.estimates))
    assert trace.rss_error.shape == (t_w,)
    solver.reset()


def t2_cfg(nt, nr):
    from twoace.config import ArrayConfig

    return ArrayConfig(nt=nt, nr=nr)
