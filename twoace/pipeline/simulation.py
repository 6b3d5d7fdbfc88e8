"""Monte-Carlo simulation drivers (the Numerical_Simulation main programs).

JAX rewrite of:
  - ``Vs_M{,_par}.m``: recovery error vs number of measurements
    (ref: Numerical_Simulation/main_programs/Vs_M_par.m:75-219)
  - ``Vs_SNR{,_par}.m``: recovery error vs SNR
  - ``VS_SR_par.m``: measurements needed vs search range
    (ref: VS_SR_par.m:73-109)
  - ``Infer_channel_ADMM.m``: windowed batch inference over a real RSS trace
    (ref: Infer_channel_ADMM.m:108-174)

The reference distributes Monte-Carlo instances over a parfor process pool;
here the instance axis is an array axis (channels, codebooks, measurements
generated in one fused computation) and solves run either vmapped (A2) or
in a short host loop (baselines whose compression size is data-adaptive).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import AdmmConfig, ArrayConfig, ChannelConfig, MethodFlags
from ..models.channel import generate_channel
from ..models.measurement import generate_measurement
from ..models.sparse import sparse_formulation
from ..ops.admm import solve_lowrank_multi
from ..ops.dispatch import recover_sparse
from ..sensing.sensing_matrix import generate_sensing_matrix
from ..utils.metrics import (
    angle_error,
    angles_from_sparse,
    nmse_h,
    nmse_h_projection,
    sparse_projection_omp,
)


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Shared Monte-Carlo scaffold (ref: Vs_M_par.m:75-134)."""

    array: ArrayConfig = ArrayConfig(nt=12, nr=12)
    channel: ChannelConfig = ChannelConfig(n_paths=1, rician_k=0)
    snr_db: float = 0.0
    add_noise: bool = True
    beam_method: str = "Directional_Beam_Angular"
    methods: MethodFlags = MethodFlags(admm_lowrank_v4=False, plomp=True,
                                       plgamp=True)
    admm: AdmmConfig = AdmmConfig()
    n_trials: int = 10
    #: "complex" (the complex-dtype stack) or "pair" — the (re, im)
    #: float32 production solver (ops/pair_solver)
    impl: str = "complex"


#: sensing modes whose rows are drawn directly (no physical F/W split)
_NO_COMBINER_MODES = ("Random_Phase_State", "Random_Beam_Bayes")


def _mt_mr(sim: SimulationConfig, m: int) -> Tuple[int, int]:
    """Interpret a grid value m as (Mt, Mr).

    Directional modes count per-side beams (total = Mt*Mr, ref:
    Vs_M_par.m:149 sweeping Mt=Mr); combiner-less random modes count TOTAL
    probe rows (ref: A2only.m:110-111, where the M grid indexes rows of the
    flashed random codebook directly).
    """
    if sim.beam_method in _NO_COMBINER_MODES:
        return m, 1
    return m, m


class SweepResult(NamedTuple):
    grid: np.ndarray                #: swept values (M, SNR, or range)
    nmse: Dict[str, np.ndarray]     #: method -> (len(grid),) mean NMSE
    aoda_err: Dict[str, np.ndarray]  #: method -> mean AoD/AoA error (deg)
    #: method -> (len(grid), n_trials) per-trial NMSE (variance control for
    #: the committed accuracy artifacts); None on paths that don't record
    #: it — a None default rather than {} so no shared mutable instance
    #: leaks across results (guard consumers with ``res.nmse_trials or {}``)
    nmse_trials: Optional[Dict[str, np.ndarray]] = None


def _recover_all(key, sim: SimulationConfig, meas, sensing, rep, ch):
    """Run enabled methods on a batch; returns {name: (U, P or n) estimates}."""
    cfg = sim.array
    out: Dict[str, np.ndarray] = {}
    batch = meas.norm_square.shape[0]

    # sparse-domain baselines: per-instance host loop (adaptive internals)
    base_flags = dataclasses.replace(sim.methods, admm_lowrank_v4=False,
                                     admm=False, admm_nuclear=False,
                                     phaselift=False)

    # Standalone PhaseLift runs in the H domain with the factored
    # Burer-Monteiro solver, vmapped over instances.  The reference's
    # z-domain lifted SDP (MyCPR.m:120-139 via TFOCS TraceLS) is the
    # "hours per solve" path (reference README.md:87) — its lifted
    # dimension is the dictionary size squared; the H-domain lift
    # (Recover_Channel.m:35, MyPhaseLift.m:69-108) plays the same
    # baseline role at n = Nt*Nr and the BM factorization keeps it
    # feasible (SURVEY §7 "hard parts").
    if sim.methods.phaselift:
        from ..ops.phaselift import phaselift_bm

        keys_pl = jax.random.split(jax.random.fold_in(key, 777), batch)

        def solve_pl(k, a, b2):
            return phaselift_bm(k, a, b2).x

        # The H-domain estimate carries no sparse support, so _evaluate
        # reports NaN AoD/AoA for it (the reference's angle metrics come
        # from the sparse z, Evaluation_Recovery.m:85-126).
        out["phaselift"] = np.asarray(jax.vmap(solve_pl)(
            keys_pl, jnp.asarray(sensing.fw), meas.norm_square))
    if base_flags.enabled() or sim.add_noise:
        per_inst = []
        for u in range(batch):
            res = recover_sparse(
                jax.random.fold_in(key, u),
                meas.norm_square[u], sensing.measurement_mat[u],
                base_flags, s=sim.channel.n_paths,
                noise_power=float(meas.noise_power),
                measurements_perfect=meas.perfect_phase[u],
                measurements_noisy=meas.noisy_phase[u])
            per_inst.append(res)
        for name in per_inst[0]:
            out[name] = np.stack([np.asarray(r[name]) for r in per_inst])

    # A2 family: vmapped over instances, H-domain
    if sim.methods.admm_lowrank_v4 or sim.methods.admm_nuclear:
        prox = "nuclear" if sim.methods.admm_nuclear else "spectral_profile"
        keys = jax.random.split(jax.random.fold_in(key, 999), batch)
        b = jnp.sqrt(meas.norm_square)
        name = "admm_nuclear" if sim.methods.admm_nuclear \
            else "admm_lowrank_v4"

        if sim.impl == "pair":
            # production path: per-instance codebooks, pair representation
            from ..ops.cplx import Pair
            from ..ops.pair_solver import solve_lowrank_multi_pair

            are = jnp.real(sensing.fw).astype(jnp.float32)
            aim = jnp.imag(sensing.fw).astype(jnp.float32)
            bf = b.astype(jnp.float32)

            def solve_p(k, ar, ai, bb):
                res = solve_lowrank_multi_pair(
                    k, Pair(ar, ai), bb, cfg.nt, cfg.nr, sim.admm,
                    prox_kind=prox)
                return res.x.re, res.x.im
            xr, xi = jax.vmap(solve_p)(keys, are, aim, bf)
            out[name] = np.asarray(xr) + 1j * np.asarray(xi)
        else:
            def solve(k, a, bb):
                return solve_lowrank_multi(k, a, bb, cfg.nt, cfg.nr,
                                           sim.admm, prox_kind=prox).x
            xs = jax.vmap(solve)(keys, sensing.fw, b)
            out[name] = np.asarray(xs)
    return out


def _evaluate(out, rep, ch, sim: SimulationConfig):
    """NMSE + angle errors per method (ref: Evaluation_Recovery.m:73-214).

    Returns ``(mean_nmse, mean_angle_err, per_trial_nmse)`` — the per-trial
    vector feeds the variance columns of the committed accuracy artifacts.
    """
    cfg = sim.array
    nmse_d, ang_d, trials_d = {}, {}, {}
    for name, est in out.items():
        est_j = jnp.asarray(est)
        if est_j.shape[-1] == rep.ad.shape[1]:       # sparse z -> vec H
            vec_est = jnp.einsum("np,up->un", rep.ad, est_j)
            z_for_ang = est_j
        else:                                        # direct vec H estimate
            vec_est = est_j
            # angle readout for H-domain solvers (A2 family, minL2,
            # phaselift): project the estimate onto the FoV dictionary and
            # read angles off the OMP support — same readout the sparse
            # methods get from their z (see metrics.sparse_projection_omp)
            from functools import partial
            z_for_ang = jax.vmap(
                partial(sparse_projection_omp,
                        n_paths=sim.channel.n_paths),
                in_axes=(0, None))(est_j, rep.ad.astype(est_j.dtype))
        aod, aoa = angles_from_sparse(z_for_ang, cfg, rep.tx_window,
                                      rep.rx_window, sim.channel.n_paths)
        ang = angle_error(aod, aoa, ch.aod_deg, ch.aoa_deg)
        ang_d[name] = float(jnp.mean(ang.aoda_err))
        per = np.asarray(nmse_h_projection(vec_est, ch.vec_h))
        trials_d[name] = per
        nmse_d[name] = float(np.mean(per))
    return nmse_d, ang_d, trials_d


def _one_cell(key, sim: SimulationConfig, mt: int, mr: int,
              searching_area: float):
    """One (config, M) Monte-Carlo cell: channels -> sensing -> measurements
    -> recovery -> metrics (ref: Vs_M_par.m:149-197).  Every stage runs on
    the default device.
    """
    cfg = sim.array
    ks = jax.random.split(key, 4)

    ch = generate_channel(ks[0], cfg, sim.channel, batch=sim.n_trials)
    rep = sparse_formulation(cfg, ch, searching_area)
    sensing = generate_sensing_matrix(
        ks[1], sim.beam_method, mt, mr, cfg, rep.ad,
        aod_range=(-searching_area / 2, searching_area / 2),
        aoa_range=(-searching_area / 2, searching_area / 2),
        batch=sim.n_trials)
    # Combiner-less modes (random 2-bit rows) get IID noise: the
    # reference leaves W = zeros there (Generate_Sensing_Matrix.m:105,
    # assignment commented out at :117), which makes its colored noise
    # diag(W' N) silently ZERO — a quirk in configuration space its
    # noisy drivers never reach; replicating it would make every
    # random-codebook sim secretly noiseless.
    w_noise = None if sim.beam_method in _NO_COMBINER_MODES \
        else sensing.w
    meas = generate_measurement(ks[2], sensing.fw, ch.vec_h, sim.snr_db,
                                sim.add_noise, w=w_noise, mt=mt)
    out = _recover_all(ks[3], sim, meas, sensing, rep, ch)
    return _evaluate(out, rep, ch, sim)


def sweep_measurements(key, m_grid: Sequence[int],
                       sim: SimulationConfig = SimulationConfig(),
                       searching_area: float = 60.0) -> SweepResult:
    """Error vs measurement count (Vs_M)."""
    nmse_acc: Dict[str, list] = {}
    ang_acc: Dict[str, list] = {}
    tr_acc: Dict[str, list] = {}
    for i, m in enumerate(m_grid):
        mt, mr = _mt_mr(sim, m)
        nm, an, tr = _one_cell(jax.random.fold_in(key, i), sim, mt, mr,
                               searching_area)
        for k, v in nm.items():
            nmse_acc.setdefault(k, []).append(v)
        for k, v in an.items():
            ang_acc.setdefault(k, []).append(v)
        for k, v in tr.items():
            tr_acc.setdefault(k, []).append(v)
        # every cell has different shapes, so nothing compiled is reusable;
        # dropping executables bounds the live-JIT count (XLA:CPU's LLVM
        # engine fails with "Cannot allocate memory" once too many
        # executables accumulate in one long-lived process)
        jax.clear_caches()
    return SweepResult(grid=np.asarray(m_grid),
                       nmse={k: np.asarray(v) for k, v in nmse_acc.items()},
                       aoda_err={k: np.asarray(v) for k, v in ang_acc.items()},
                       nmse_trials={k: np.stack(v)
                                    for k, v in tr_acc.items()})


def sweep_snr(key, snr_grid: Sequence[float], m: int,
              sim: SimulationConfig = SimulationConfig(),
              searching_area: float = 60.0) -> SweepResult:
    """Error vs SNR (Vs_SNR)."""
    nmse_acc: Dict[str, list] = {}
    ang_acc: Dict[str, list] = {}
    tr_acc: Dict[str, list] = {}
    for i, snr in enumerate(snr_grid):
        sim_i = dataclasses.replace(sim, snr_db=float(snr))
        mt, mr = _mt_mr(sim_i, m)
        nm, an, tr = _one_cell(jax.random.fold_in(key, i), sim_i, mt, mr,
                               searching_area)
        for k, v in nm.items():
            nmse_acc.setdefault(k, []).append(v)
        for k, v in an.items():
            ang_acc.setdefault(k, []).append(v)
        for k, v in tr.items():
            tr_acc.setdefault(k, []).append(v)
        # NOTE: no clear_caches() here — unlike sweep_measurements, every
        # SNR cell shares identical shapes, so the compiled solver is
        # reused across the whole grid (clearing would force a full
        # recompile per SNR point for no memory benefit).
    return SweepResult(grid=np.asarray(snr_grid),
                       nmse={k: np.asarray(v) for k, v in nmse_acc.items()},
                       aoda_err={k: np.asarray(v) for k, v in ang_acc.items()},
                       nmse_trials={k: np.stack(v)
                                    for k, v in tr_acc.items()})


#: The reference's per-search-range (Mt=Mr grid, G grid) pairs
#: (VS_SR_par.m:76-99): G sets the per-side AoD/AoA quantization NQt=NQr
#: for that point (sub_VS_SR_par.m:133-135).
VS_SR_GRIDS: Dict[int, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    20: ((2, 3, 4, 5), (25, 35, 45, 55)),
    30: ((4, 5, 6, 7), (25, 40, 55, 60)),
    40: ((5, 6, 7, 8, 9), (25, 40, 55, 60, 70)),
    50: ((6, 7, 8, 9, 10, 11), (25, 40, 45, 55, 65, 70)),
    60: ((8, 9, 10, 11, 12), (40, 50, 55, 60, 70)),
    70: ((9, 10, 11, 12, 13), (40, 55, 60, 70, 75)),
    80: ((10, 11, 12, 13, 14), (45, 55, 60, 70, 75)),
}


class VsSrResult(NamedTuple):
    ranges: np.ndarray                 #: (R,) search ranges in degrees
    maee_targets: Tuple[float, ...]    #: the MAEE ladder (degrees)
    #: method -> (R, T) TOTAL measurements whose MAEE is closest to each
    #: target (the reference reports M^2, VS_SR_par.m:118-121)
    m_needed: Dict[str, np.ndarray]
    #: method -> list over ranges of per-grid-point MAEE (degrees)
    maee_curves: Dict[str, list]
    #: method -> list over ranges of per-grid-point mean NMSE (linear)
    nmse_curves: Dict[str, list]
    m_grids: list                      #: per-range Mt=Mr (or total-M) grids
    g_grids: list                      #: per-range dictionary sizes


def measurements_needed_vs_range(key, ranges_deg: Sequence[float],
                                 m_grid: Optional[Sequence[int]] = None,
                                 g_grid: Optional[Sequence[int]] = None,
                                 maee_targets: Sequence[float] = (
                                     0.6, 0.8, 1.0),
                                 sim: SimulationConfig = SimulationConfig()
                                 ) -> VsSrResult:
    """Measurements needed vs search range, at the reference's semantics.

    ref: VS_SR_par.m:73-121 + sub_VS_SR_par.m — per-range (M, G) grids
    (:data:`VS_SR_GRIDS`; G sets the dictionary quantization for that
    point), SNR fixed by ``sim.snr_db`` (the reference uses 0 dB), and for
    each MAEE target the selected budget is the grid point whose mean
    angle error is CLOSEST to the target (``min |MAEE - target|``,
    VS_SR_par.m:118-119 — not "first M reaching it"), reported as total
    measurements Mt*Mr.

    ``m_grid``/``g_grid`` override the table with one shared grid for all
    ranges (ragged per-range grids stay the default).  H-domain methods
    (the A2 family) get their MAEE through the dictionary projection in
    :func:`_evaluate`, so every enabled method yields a finite row.
    """
    maee_acc: Dict[str, list] = {}
    nmse_acc: Dict[str, list] = {}
    m_grids, g_grids = [], []
    for r_i, sr in enumerate(ranges_deg):
        if m_grid is not None:
            ms = tuple(m_grid)
            gs = tuple(g_grid) if g_grid is not None \
                else (sim.array.grid_t,) * len(ms)
        else:
            try:
                ms, gs = VS_SR_GRIDS[int(round(sr))]
            except KeyError:
                raise ValueError(
                    f"no reference (M, G) grid for range {sr}deg "
                    f"(table covers {sorted(VS_SR_GRIDS)}); pass m_grid")
        m_grids.append(list(ms))
        g_grids.append(list(gs))
        maee_r: Dict[str, list] = {}
        nmse_r: Dict[str, list] = {}
        for j, (m_j, g_j) in enumerate(zip(ms, gs)):
            sim_j = dataclasses.replace(
                sim, array=dataclasses.replace(sim.array, nqt=int(g_j),
                                               nqr=int(g_j)))
            mt, mr = _mt_mr(sim_j, m_j)
            nm, an, _ = _one_cell(
                jax.random.fold_in(key, r_i * 1024 + j), sim_j, mt, mr,
                float(sr))
            for k, v in an.items():
                maee_r.setdefault(k, []).append(v)
            for k, v in nm.items():
                nmse_r.setdefault(k, []).append(v)
            jax.clear_caches()     # every point has fresh shapes
        for k, v in maee_r.items():
            maee_acc.setdefault(k, []).append(np.asarray(v))
        for k, v in nmse_r.items():
            nmse_acc.setdefault(k, []).append(np.asarray(v))

    m_needed: Dict[str, np.ndarray] = {}
    for k, curves in maee_acc.items():
        sel = np.full((len(ranges_deg), len(maee_targets)), np.nan)
        for r_i, curve in enumerate(curves):
            ms = m_grids[r_i]
            for t_i, tgt in enumerate(maee_targets):
                p = int(np.nanargmin(np.abs(np.asarray(curve) - tgt)))
                mt, mr = _mt_mr(sim, ms[p])
                sel[r_i, t_i] = mt * mr
        m_needed[k] = sel
    return VsSrResult(ranges=np.asarray(ranges_deg),
                      maee_targets=tuple(maee_targets),
                      m_needed=m_needed, maee_curves=maee_acc,
                      nmse_curves=nmse_acc, m_grids=m_grids,
                      g_grids=g_grids)


def sweep_measurements_trace(key, h_traces, m_grid: Sequence[int],
                             sim: SimulationConfig = SimulationConfig(),
                             searching_area: float = 180.0,
                             normalize: bool = True) -> SweepResult:
    """Error vs measurement count on externally supplied channel traces.

    ref: Numerical_Simulation/main_programs/Vs_M_Wireless_Insite.m:140-233 —
    instead of Eq.-23 synthetic channels, each Monte-Carlo instance wraps one
    ray-traced / measured H via ``construct_channel_representation`` (per-entry
    magnitude normalization ``H ./ abs(H)``, ref :167-172), then runs the same
    sensing -> measurement -> recovery -> evaluation cell.  Angle metrics are
    reported as NaN (trace channels carry no ground-truth path angles).
    """
    from ..models.channel import from_matrix

    ch = from_matrix(jnp.asarray(h_traces), normalize=normalize)
    cfg = sim.array
    sim = dataclasses.replace(sim, n_trials=ch.h_matrix.shape[0])
    nmse_acc: Dict[str, list] = {}
    ang_acc: Dict[str, list] = {}
    for i, m in enumerate(m_grid):
        ks = jax.random.split(jax.random.fold_in(key, i), 3)
        rep = sparse_formulation(cfg, ch, searching_area)
        mt, mr = _mt_mr(sim, m)
        sensing = generate_sensing_matrix(
            ks[0], sim.beam_method, mt, mr, cfg, rep.ad,
            aod_range=(-searching_area / 2, searching_area / 2),
            aoa_range=(-searching_area / 2, searching_area / 2),
            batch=sim.n_trials)
        w_noise = None if sim.beam_method in _NO_COMBINER_MODES \
            else sensing.w
        meas = generate_measurement(ks[1], sensing.fw, ch.vec_h, sim.snr_db,
                                    sim.add_noise, w=w_noise, mt=mt)
        out = _recover_all(ks[2], sim, meas, sensing, rep, ch)
        for name, est in out.items():
            est_j = jnp.asarray(est)
            if est_j.shape[-1] == rep.ad.shape[1]:
                vec_est = jnp.einsum("np,up->un", rep.ad, est_j)
            else:
                vec_est = est_j
            nmse_acc.setdefault(name, []).append(
                float(jnp.mean(nmse_h_projection(vec_est, ch.vec_h))))
            ang_acc.setdefault(name, []).append(float("nan"))
    return SweepResult(grid=np.asarray(m_grid),
                       nmse={k: np.asarray(v) for k, v in nmse_acc.items()},
                       aoda_err={k: np.asarray(v) for k, v in ang_acc.items()})


def infer_channel_windows(key, cb_rows, rss_amps, cfg: ArrayConfig,
                          window: int = 200, n_windows: int = 30,
                          admm: AdmmConfig = AdmmConfig()) -> np.ndarray:
    """Windowed batch inference over a recorded RSS trace.

    ref: Infer_channel_ADMM.m:147-171 — window i uses probes
    [i*window, (i+1)*window); returns (n_windows, nr, nt) estimates.
    """
    ests = []
    for i in range(n_windows):
        sl = slice(i * window, (i + 1) * window)
        res = solve_lowrank_multi(jax.random.fold_in(key, i),
                                  jnp.asarray(cb_rows[sl]),
                                  jnp.asarray(rss_amps[sl]),
                                  cfg.nt, cfg.nr, admm)
        ests.append(np.asarray(res.x).reshape(cfg.nt, cfg.nr).T)
    return np.stack(ests)
