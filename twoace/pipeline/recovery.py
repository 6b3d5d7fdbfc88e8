"""Recovery campaign entry points — the MATLAB-engine entry scripts, as a
library.

JAX rewrite of the five ``channel_recovery_ADMM_v2_simulation_*.m``
entry points (ref: main/channel_recovery_ADMM_v2_simulation_A2only.m:9-179,
_A2nuclear.m, _multiresolution.m:111-143, _phaselift.m, _directional.m):
given a probed codebook and its measured RSS trace, sweep the probe-budget
grid M and recover the channel with every enabled method.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import (
    MULTIRES_SEPARATION,
    MULTIRES_THRESHOLDS,
    AdmmConfig,
    ArrayConfig,
    ChannelConfig,
    DEFAULT_RSS_FCT,
    MethodFlags,
    SEED_TABLE,
    probe_budget_grid,
)
from ..models.steering import angle_dictionary
from ..ops.dispatch import recover_channel
from ..sensing.sensing_matrix import pick_beams
from ..utils.units import dbm_to_amplitude


class RecoveryOutput(NamedTuple):
    h_amp: np.ndarray     #: (len(m_grid), n_methods, n) |H| estimates
    h_angle: np.ndarray   #: (len(m_grid), n_methods, n) angle(H)
    m_grid: Tuple[int, ...]
    methods: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Shared scaffold of the entry points (ref: A2only.m:37-64)."""

    array: ArrayConfig = ArrayConfig()
    searching_area_deg: float = 95.0
    n_paths: int = 3
    rss_fct: float = DEFAULT_RSS_FCT
    beam_mode: str = "Random_Phase_State"   #: or "Bayes_Beam"
    multires: bool = False
    multires_thresholds: Tuple[int, int] = MULTIRES_THRESHOLDS
    multires_separation: Tuple[int, int, int] = MULTIRES_SEPARATION
    admm: AdmmConfig = AdmmConfig()


def _pick_m_indices(key, m_cur: int, total: int, cc: CampaignConfig):
    """Probe subset selection, tier-aware for multires.

    ref: A2only.m:137 (plain randperm) and multiresolution.m:137-143
    (tier thresholds 96/256 with row offsets 1984/3968/3968).
    """
    if cc.multires:
        t1, t2 = cc.multires_thresholds
        s1, s2, s3 = cc.multires_separation
        if m_cur <= t1:
            lo, size = 0, min(s1, total)
        elif m_cur <= t2:
            lo, size = s1, min(s2, max(total - s1, 1))
        else:
            lo, size = s1 + s2, min(s3, max(total - s1 - s2, 1))
        perm = jax.random.permutation(key, size)[:m_cur] + lo
        return perm
    return jax.random.permutation(key, total)[:m_cur]


def recover_campaign(cb_rows, rss_dbm, methods: MethodFlags,
                     cc: CampaignConfig = CampaignConfig(),
                     seed_id: int = 1,
                     m_grid: Optional[Tuple[int, ...]] = None,
                     nuclear: bool = False) -> RecoveryOutput:
    """Sweep the probe-budget grid and recover with every enabled method.

    ``cb_rows``: (total, nt*nr) complex probe rows (the compiled codebook);
    ``rss_dbm``: (total,) measured RSS in dBm.  ``seed_id`` indexes the
    reference's fixed seed table (ref: A2only.m:103-104).

    Returns amplitude/angle arrays scaled back by 1/rss_fct
    (ref: A2only.m:170).
    """
    cfg = cc.array
    n = cfg.n
    cb_rows = jnp.asarray(cb_rows)
    rss_dbm = jnp.asarray(rss_dbm).reshape(-1)
    total = cb_rows.shape[0]
    if m_grid is None:
        m_grid = probe_budget_grid(cfg.nt, cfg.nr)
    key = jax.random.PRNGKey(SEED_TABLE[(seed_id - 1) % len(SEED_TABLE)])

    # amplitude chain (ref: A2only.m:139)
    amps = dbm_to_amplitude(rss_dbm, cc.rss_fct)
    ad = angle_dictionary(cfg, cc.searching_area_deg, dtype=cb_rows.dtype)

    flags = methods
    if nuclear:
        flags = dataclasses.replace(methods, admm_lowrank_v4=False,
                                    admm_nuclear=True)
    method_names = tuple(flags.enabled())

    h_amp = np.zeros((len(m_grid), len(method_names), n))
    h_angle = np.zeros_like(h_amp)

    for i, m_cur in enumerate(m_grid):
        m_cur = min(m_cur, total)
        k_i = jax.random.fold_in(key, i)
        m_idx = _pick_m_indices(k_i, m_cur, total, cc)
        cb_train = cb_rows[m_idx]
        rss_train = amps[m_idx]
        picked = pick_beams(jax.random.fold_in(k_i, 1), cc.beam_mode, m_cur,
                            cb_train)
        beams = cb_train[picked]
        meas = rss_train[picked]

        est = recover_channel(jax.random.fold_in(k_i, 2), meas, beams, flags,
                              cfg, s=cc.n_paths, ad=ad, admm_cfg=cc.admm)
        for j, name in enumerate(method_names):
            h = np.asarray(est[name]) / cc.rss_fct
            h = np.nan_to_num(h)
            h_amp[i, j] = np.abs(h)
            h_angle[i, j] = np.angle(h)
    return RecoveryOutput(h_amp=h_amp, h_angle=h_angle, m_grid=tuple(m_grid),
                          methods=method_names)


def recover_a2only(cb_rows, rss_dbm, seed_id: int = 1,
                   cc: CampaignConfig = CampaignConfig()) -> RecoveryOutput:
    """ADMMLowRankV4 only (ref: channel_recovery_ADMM_v2_simulation_A2only.m)."""
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id)


def recover_a2nuclear(cb_rows, rss_dbm, seed_id: int = 1,
                      cc: CampaignConfig = CampaignConfig()) -> RecoveryOutput:
    """Nuclear-norm variant (ref: ..._A2nuclear.m; seeds [1024,2048,...] in
    the reference collapse to the same table here)."""
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id,
                            nuclear=True)


def recover_multiresolution(cb_rows, rss_dbm, seed_id: int = 1,
                            cc: Optional[CampaignConfig] = None
                            ) -> RecoveryOutput:
    """Tier-aware multires sampling (ref: ..._multiresolution.m:111-143)."""
    if cc is None:
        cc = CampaignConfig(multires=True)
    return recover_campaign(cb_rows, rss_dbm,
                            MethodFlags(admm_lowrank_v4=True), cc, seed_id)


def recover_phaselift(cb_rows, rss_dbm, seed_id: int = 1,
                      cc: CampaignConfig = CampaignConfig()) -> RecoveryOutput:
    """PhaseLift baseline entry (ref: ..._phaselift.m)."""
    return recover_campaign(cb_rows, rss_dbm, MethodFlags(
        admm_lowrank_v4=False, phaselift=True), cc, seed_id)


def recover_directional(cb_rows, rss_dbm, seed_id: int = 1,
                        cc: Optional[CampaignConfig] = None) -> RecoveryOutput:
    """PLOMP/PLGAMP on a directional codebook (ref: ..._directional.m —
    d = 2.9 mm, 180 deg search area)."""
    if cc is None:
        cc = CampaignConfig(
            array=ArrayConfig(spacing=2.9e-3),
            searching_area_deg=180.0)
    return recover_campaign(cb_rows, rss_dbm, MethodFlags(
        admm_lowrank_v4=False, plomp=True, plgamp=True), cc, seed_id)


def recover_warm_sweep(cb_rows, rss_dbm, seed_id: int = 1,
                       cc: CampaignConfig = CampaignConfig(),
                       m_grid: Optional[Tuple[int, ...]] = None,
                       quality_gate: float = 0.6):
    """Warm-started coarse->fine probe-budget sweep (A2 only).

    The realization of SURVEY §7 stage 4: the multi-resolution /
    M-grid sweep is a *pipeline over time* — each budget's solution seeds
    the next, so only the first (coarsest) cell pays for the full
    3-restart inferLowRankV4_multi scaffold.  Subsequent cells run a single
    refinement-phase ADMM from the previous estimate (exactly the
    reference's full-data refinement step, ref: inferLowRankV4_multi.m:89-101)
    and fall back to the full solve when the held-out quality drops below
    ``quality_gate`` (same gate as the reference's rank-1 retry, ref :73).

    Returns ``(RecoveryOutput, qualities)``.
    """
    from ..ops.admm import (
        _make_prox,
        _normalize_problem,
        _quality,
        infer_admm,
        solve_lowrank_multi,
    )

    cfg = cc.array
    n = cfg.n
    cb_rows = jnp.asarray(cb_rows)
    rss_dbm = jnp.asarray(rss_dbm).reshape(-1)
    total = cb_rows.shape[0]
    if m_grid is None:
        m_grid = probe_budget_grid(cfg.nt, cfg.nr)
    key = jax.random.PRNGKey(SEED_TABLE[(seed_id - 1) % len(SEED_TABLE)])
    amps = dbm_to_amplitude(rss_dbm, cc.rss_fct)

    h_amp = np.zeros((len(m_grid), 1, n))
    h_angle = np.zeros_like(h_amp)
    qualities = []
    x_prev = None

    for i, m_cur in enumerate(m_grid):
        m_cur = min(m_cur, total)
        k_i = jax.random.fold_in(key, i)
        m_idx = _pick_m_indices(k_i, m_cur, total, cc)
        a = cb_rows[m_idx]
        b = jnp.real(amps[m_idx])

        if x_prev is None:
            res = solve_lowrank_multi(jax.random.fold_in(k_i, 2), a, b,
                                      cfg.nt, cfg.nr, cc.admm)
            x, q = res.x, float(res.quality)
        else:
            # refinement-only warm solve on the normalized problem
            a_n, b_n, a_norm, b_norm = _normalize_problem(a, b,
                                                          cc.admm.tol_abs)
            x0 = (x_prev * (a_norm / b_norm).astype(a.dtype))[:, None]
            prox = _make_prox("spectral_profile", cfg.nt, cfg.nr,
                              a.shape[0], n, False, cc.admm, "jacobi")
            xr, _, _ = infer_admm(a_n, b_n, x0, scale_by_row=True, prox=prox,
                                  mu0=cc.admm.mu0, rho=cc.admm.rho,
                                  tol_rel=cc.admm.tol_rel,
                                  tol_abs=cc.admm.tol_abs,
                                  maxiter=cc.admm.maxiter)
            x = xr[:, 0] * (b_norm / a_norm).astype(a.dtype)
            q = float(_quality(a, b, x[:, None]))
            if not np.isfinite(q) or q < quality_gate:
                res = solve_lowrank_multi(jax.random.fold_in(k_i, 2), a, b,
                                          cfg.nt, cfg.nr, cc.admm)
                x, q = res.x, float(res.quality)
        x_prev = x
        qualities.append(q)
        h = np.nan_to_num(np.asarray(x) / cc.rss_fct)
        h_amp[i, 0] = np.abs(h)
        h_angle[i, 0] = np.angle(h)

    return (RecoveryOutput(h_amp=h_amp, h_angle=h_angle,
                           m_grid=tuple(m_grid),
                           methods=("admm_lowrank_v4_warm",)),
            qualities)
