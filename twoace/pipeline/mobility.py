"""Adaptive mobility tracking.

JAX rewrite of the RSS_Mobility loop
(ref: Numerical_Simulation/main_programs/RSS_Mobility.m:146-190 and
RSS_Mobility_simu.m): per time window, predict RSS with the previous channel
estimate; if the prediction error exceeds a threshold, grow the probe budget
``M <- min(ceil(1.2 M + 1), M_max)`` and re-solve on a sliding window of the
most recent probes; otherwise reset the budget to zero.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import AdmmConfig, ArrayConfig
from ..ops.admm import solve_lowrank_multi


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """ref: RSS_Mobility.m:128-131."""

    window_probes: int = 62     #: probes per time window (T_size)
    max_window: int = 80        #: sliding-window cap (Mw_max)
    threshold: float = 0.3      #: rss-error threshold for re-probing
    growth: float = 1.2         #: probe-budget growth factor
    admm: AdmmConfig = AdmmConfig()


class MobilityTrace(NamedTuple):
    rss_error: np.ndarray       #: (T,) per-window prediction error
    probe_budget: np.ndarray    #: (T,) adaptive M at each window
    estimates: np.ndarray       #: (T, n) channel estimate per window


def _relative_rss_error(rss_pred, rss_actual, eps: float = 1e-12) -> float:
    """Mean relative RSS prediction error (ref: Evaluate_rss.m:1-7) with a
    floor on the denominator: a zero/near-zero amplitude probe (a dead
    beam or a padded row) must not yield inf/NaN, which would permanently
    saturate the probe-budget loop."""
    denom = np.maximum(np.abs(rss_actual), eps)
    return float(np.mean(np.abs(rss_pred - rss_actual) / denom))


def _pad_window(cb_rows, rss_amps, window: List[int], max_window: int):
    """Static-shape sliding window: always (max_window, n) / (max_window,),
    with the unoccupied tail as INACTIVE rows (A_i = 0, b_i = 0).

    The solver treats b == 0 rows as exactly absent (y-prox = 0, effective
    row count m_eff excludes them — see ops.cplx.magnitude_prox_rows and
    ops.admm._normalize_problem), so the padded solve equals the dynamic
    one while the jitted solver compiles ONCE per tracking run instead of
    once per distinct window length (the reference re-solves per window,
    RSS_Mobility.m:155-188; a fresh XLA trace per length would cost
    minutes of compile to save milliseconds of solve).

    Host-side numpy on purpose: the tracking driver is sequential control
    (like the reference's loop); the solver callback owns all device
    work.
    """
    k = len(window)
    n = cb_rows.shape[1]
    a = np.zeros((max_window, n), cb_rows.dtype)
    b = np.zeros((max_window,), rss_amps.dtype)
    idx = np.asarray(window)
    a[:k] = cb_rows[idx]
    b[:k] = rss_amps[idx]
    return a, b


def _solver_takes_ladder_m(solver) -> bool:
    """Whether a tracking solver callback accepts the ``ladder_m`` kwarg
    (custom callbacks without it keep working, at padded-ladder fidelity).

    An explicit ``ladder_m`` parameter in the signature, or the
    ``solver.takes_ladder_m = True`` attribute, opts in.  A bare
    ``**kwargs`` does NOT: a legacy callback that merely swallows kwargs
    would silently receive (and likely ignore) ladder_m while the tracker
    believed active-count ladder selection was in effect."""
    if getattr(solver, "takes_ladder_m", False):
        return True
    try:
        params = inspect.signature(solver).parameters
    except (TypeError, ValueError):
        return False
    return "ladder_m" in params


def _solver_cc_frac(solver, default: float) -> float:
    """The train-split fraction the solver actually uses — the ladder snap
    must evaluate the train-ladder boundary with the SOLVER's cc_frac, not
    the tracking config's (they may carry different AdmmConfigs).  Solver
    callbacks built by this module set ``solver.cc_frac``; custom callbacks
    that accept ladder_m must do the same if their fraction differs — warn
    when the attribute is absent so a mismatched snap is not silent."""
    cc = getattr(solver, "cc_frac", None)
    if cc is None:
        import warnings
        warnings.warn(
            "tracking solver accepts ladder_m but carries no .cc_frac "
            "attribute; ladder snapping falls back to the tracking "
            f"config's cc_frac={default} — set solver.cc_frac to the "
            "fraction the solver's own AdmmConfig uses",
            stacklevel=3)
        cc = default
    return float(cc)


def _ladder_m_for_window(m_active: int, m_padded: int, n: int,
                         frac: float = 0.95):
    """Snap the active window length to a canonical ladder-equivalent count.

    The constraint-ladder selection depends on the row count only through
    the booleans ``m >= 3n`` (full-data ladder) and ``floor(m*frac) >= 3n``
    (train-split ladder), ref: inferLowRankV4_multi.m:447.  A padded
    problem must select ladders by its ACTIVE count, but passing the raw
    length as a static solver arg would recompile per distinct length —
    so return one canonical representative per boolean pair (at most 3
    compiled variants per run), or None when the padded count already
    selects the same ladders.
    """
    def pair(m):
        return (m >= 3 * n, math.floor(m * frac) >= 3 * n)

    if pair(m_active) == pair(m_padded):
        return None
    b1, b2 = pair(m_active)
    if not b1:
        return 3 * n - 1
    if not b2:
        return 3 * n
    return math.ceil(3 * n / frac)


def track(key, cb_rows, rss_amps, cfg: ArrayConfig,
          mob: MobilityConfig = MobilityConfig(),
          solver: Optional[Callable] = None,
          static_pad: bool = True) -> MobilityTrace:
    """Run the adaptive tracking loop over a probe stream.

    ``cb_rows``: (T * window_probes, n) probe rows in time order;
    ``rss_amps``: matching linear RSS amplitudes.  ``solver(key, a, b) -> x``
    defaults to the A2 spectral-profile ADMM.

    Note the sliding window holds *whole* windows of probes, trimmed to the
    last ``max_window`` probes (ref :169-174); the reference always re-solves
    on the current window content regardless of the budget M, whose role is
    purely to be recorded/plotted — replicated here.

    ``static_pad`` pads every solve to ``max_window`` rows with inactive
    (b = 0) rows so the jitted solver traces/compiles once per run (see
    :func:`_pad_window`); pass False for the reference's dynamic shapes.
    """
    n = cfg.n
    t_size = mob.window_probes
    # host-side driver state; the solver callback owns device work
    cb_rows = np.asarray(cb_rows)
    rss_amps = np.asarray(rss_amps)
    total = cb_rows.shape[0]
    n_windows = total // t_size

    if solver is None:
        def solver(k, a, b, ladder_m=None):
            return solve_lowrank_multi(k, jnp.asarray(a), jnp.asarray(b),
                                       cfg.nt, cfg.nr, mob.admm,
                                       ladder_m=ladder_m).x
        solver.cc_frac = mob.admm.cc_frac

    takes_ladder_m = _solver_takes_ladder_m(solver)
    h = np.zeros((n,), cb_rows.dtype)
    m_budget = 0
    window: List[int] = []

    errors = np.zeros(n_windows)
    budgets = np.zeros(n_windows, np.int64)
    estimates = np.zeros((n_windows, n), np.complex128)

    for t in range(n_windows):
        budgets[t] = m_budget
        cur = list(range(t * t_size, (t + 1) * t_size))
        cb_cur = cb_rows[np.asarray(cur)]
        rss_cur = rss_amps[np.asarray(cur)]

        rss_eval = np.abs(cb_cur @ h)                    # Evaluate_rss.m:1-7
        err = _relative_rss_error(rss_eval, rss_cur)
        errors[t] = err
        if err < mob.threshold:
            m_budget = 0
        else:
            m_budget = min(int(np.ceil(m_budget * mob.growth + 1)),
                           mob.max_window)
        window = (window + cur)[-mob.max_window:]

        if static_pad:
            a_w, b_w = _pad_window(cb_rows, rss_amps, window, mob.max_window)
            lm = (_ladder_m_for_window(len(window), mob.max_window, n,
                                       _solver_cc_frac(solver,
                                                       mob.admm.cc_frac))
                  if takes_ladder_m else None)
        else:
            idx = np.asarray(window)
            a_w, b_w = cb_rows[idx], rss_amps[idx]
            lm = None
        kw = {"ladder_m": lm} if lm is not None else {}
        h = np.asarray(solver(jax.random.fold_in(key, t), a_w, b_w, **kw))
        estimates[t] = h
    return MobilityTrace(rss_error=errors, probe_budget=budgets,
                        estimates=estimates)


def make_pair_solver(cfg: ArrayConfig, admm: AdmmConfig = AdmmConfig()
                     ) -> Callable:
    """A tracking solver running the pair-form A2 path (the production
    solver representation).

    Combined with ``static_pad`` the jitted pair solver compiles once per
    tracking run.
    """
    from ..ops.cplx import Pair
    from ..ops.pair_solver import solve_lowrank_multi_pair

    def solver(k, a, b, ladder_m=None):
        a = np.asarray(a)                 # split re/im on the host
        ap = Pair(jnp.asarray(a.real, jnp.float32),
                  jnp.asarray(a.imag, jnp.float32))
        res = solve_lowrank_multi_pair(k, ap,
                                       jnp.asarray(np.asarray(b), jnp.float32),
                                       cfg.nt, cfg.nr, admm,
                                       ladder_m=ladder_m)
        return np.asarray(res.x.re) + 1j * np.asarray(res.x.im)

    solver.cc_frac = admm.cc_frac     # ladder-snap boundary (see track())
    return solver


def make_warm_pair_solver(cfg: ArrayConfig, admm: AdmmConfig = AdmmConfig(),
                          quality_gate: float = 0.6,
                          anchor_weight: float = 3.0,
                          use_rank_one: bool = False) -> Callable:
    """A tracking solver that WARM-STARTS each window from the previous
    window's estimate (pair form, one compile per run with static_pad).

    The reference re-solves cold per window (RSS_Mobility.m:155-188);
    nothing forbids doing better: a slowly-moving channel makes window t's
    solution an excellent initialization for window t+1, so the warm path
    runs ONE refinement-style solve (the reference's own full-data
    refinement step, inferLowRankV4_multi.m:89-101) and only falls back to
    the full 3-restart scaffold when the refined fit decays below
    ``quality_gate`` (the scaffold's own gate, ref :73) — e.g. after an
    abrupt channel change.  The refinement carries a PROXIMAL ANCHOR
    (``anchor_weight * ||x - x_prev||^2`` in the X-subproblem) so it also
    ACCUMULATES cross-window beam diversity: with the testbed's kron
    probing (one Rx sector per round, RSS_Mobility.m
    "cb = kron(rx_codebook, tx_codebook)"), any single 80-probe window
    spans only ~2 Rx sectors and cannot pin the Rx-side factor — measured:
    un-anchored re-solves leave the tracked NMSE at ~0 dB forever because
    every window re-randomizes the unmeasured directions; the anchor keeps
    them at the previous estimate so each new sector adds information.
    The retained fraction scales like 1/(1 + anchor_weight) against the
    solve's transient drift (measured: dist-from-anchor 0.74/0.48/0.25/
    0.10/0.03 at weight 0/0.3/1/3/10 on an under-determined kron window),
    so the default weight 3 keeps ~90% of unmeasured structure while the
    quality gate still catches genuine channel jumps.

    ``use_rank_one=True`` pins the tracking solves to the rank-1 constraint
    ladder — the mobile-LOS regime the adaptive loop targets (and the same
    ladder as the scaffold's own fallback, ref :73-77).  Measured on the
    kron workload: the generic ladder's extra rank freedom absorbs the
    window's 62 Tx-sweep magnitudes without isolating the Tx factor
    (at-alignment ~random), while the rank-1 ladder pins it to 0.998+
    every window, which is what makes next-window RSS prediction — and
    hence the budget-reset branch — reachable at all.
    """
    import numpy as np

    from ..ops.cplx import Pair
    from ..ops.pair_solver import (_normalize_problem_pair,
                                   refine_lowrank_pair,
                                   solve_lowrank_multi_pair,
                                   spectral_initialize_pair)

    state = {"x": None}

    def cold_start(k, ap, bf, kw):
        if not use_rank_one:
            return solve_lowrank_multi_pair(k, ap, bf, cfg.nt, cfg.nr,
                                            admm, **kw)
        # rank-1 cold start: top spectral vector -> rank-1-ladder refine
        a_n, b_n, a_norm, b_norm = _normalize_problem_pair(ap, bf,
                                                           admm.tol_abs)
        xs = spectral_initialize_pair(a_n, b_n, 1, key=k)
        s = b_norm / a_norm
        x0 = Pair(xs.re[0] * s, xs.im[0] * s)
        return refine_lowrank_pair(ap, bf, x0, cfg.nt, cfg.nr, admm,
                                   use_rank_one=True, **kw)

    def solver(k, a, b, ladder_m=None):
        a = np.asarray(a)                 # host split (no complex on-device)
        ap = Pair(jnp.asarray(a.real, jnp.float32),
                  jnp.asarray(a.imag, jnp.float32))
        bf = jnp.asarray(np.asarray(b), jnp.float32)
        kw = dict(ladder_m=ladder_m) if ladder_m is not None else {}
        if state["x"] is not None:
            x0 = Pair(jnp.asarray(state["x"].real, jnp.float32),
                      jnp.asarray(state["x"].imag, jnp.float32))
            res = refine_lowrank_pair(ap, bf, x0, cfg.nt, cfg.nr, admm,
                                      anchor_weight=anchor_weight,
                                      use_rank_one=use_rank_one, **kw)
            if float(res.quality) < quality_gate:
                res = cold_start(k, ap, bf, kw)
        else:
            res = cold_start(k, ap, bf, kw)
        x = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
        state["x"] = x
        return x

    solver.cc_frac = admm.cc_frac
    solver.takes_ladder_m = True
    solver.reset = lambda: state.update(x=None)
    return solver


@dataclasses.dataclass(frozen=True)
class SimulatedMobilityConfig:
    """ref: RSS_Mobility_simu.m:112-115,133-163."""

    window_probes: int = 100    #: probes per time window
    max_window: int = 400       #: sliding-window probe cap
    threshold: float = 0.2      #: rss-error threshold driving the budget
    m_init: int = 80            #: initial probe budget
    m_max: int = 80             #: probe-budget cap
    max_angle_change_deg: float = 1.0  #: Brownian per-window angle jitter
    admm: AdmmConfig = AdmmConfig()


def brownian_trace(key, cfg: ArrayConfig,
                   mob: SimulatedMobilityConfig = SimulatedMobilityConfig(),
                   n_windows: int = 20, channel_cfg=None):
    """Synthesize a Brownian-mobility probe stream.

    Stands in for the reference's pregenerated
    ``rss_trace_movement_simu_12x12_brownian`` dataset
    (ref: RSS_Mobility_simu.m:100-105): per window the channel's AoD/AoA
    random-walk by <= ``max_angle_change_deg`` (Generate_Dynamic_Channel
    semantics) and every probe is an independent random 2-bit phase row.
    Returns ``(cb_rows, rss_amps, vec_h_per_window)``.
    """
    from ..config import ChannelConfig
    from ..models.channel import generate_channel, perturb_channel
    from ..sensing.codebooks import random_sensing_rows

    if channel_cfg is None:
        channel_cfg = ChannelConfig(n_paths=2)
    p = mob.window_probes
    kc, kb = jax.random.split(key)
    ch = generate_channel(kc, cfg, channel_cfg, batch=1)
    cb = random_sensing_rows(kb, n_windows * p, cfg.n, cfg.phase_bit)

    vec_hs = []
    for t in range(n_windows):
        ch = perturb_channel(jax.random.fold_in(kc, t + 1), ch, cfg,
                             mob.max_angle_change_deg)
        vec_hs.append(ch.vec_h[0])
    vec_h = jnp.stack(vec_hs)                            # (T, n)
    rss = jnp.abs(jnp.einsum("tpn,tn->tp",
                             cb.reshape(n_windows, p, -1), vec_h))
    return cb, rss.reshape(-1), vec_h


def track_simulated(key, cb_rows, rss_amps, cfg: ArrayConfig,
                    mob: SimulatedMobilityConfig = SimulatedMobilityConfig(),
                    solver: Optional[Callable] = None,
                    static_pad: bool = True) -> MobilityTrace:
    """Adaptive tracking with the simulated-trace budget rule.

    ref: RSS_Mobility_simu.m:133-163 — window t contributes its first M
    probes to a sliding window capped at ``max_window``; the estimate is
    scored on the *held-out remainder* of the window (probes M+1..P), and the
    budget shrinks ``M <- max(0, M - floor(M/5) - 1)`` on success or grows
    ``M <- min(m_max, M + floor(M/5) + 1)`` on failure.

    The adaptive budget makes window lengths highly variable — without
    ``static_pad`` every distinct length is a fresh solver trace+compile
    (see :func:`_pad_window`).
    """
    n = cfg.n
    p = mob.window_probes
    cb_rows = np.asarray(cb_rows)         # host-side driver (see track())
    rss_amps = np.asarray(rss_amps)
    n_windows = cb_rows.shape[0] // p

    if solver is None:
        def solver(k, a, b, ladder_m=None):
            return solve_lowrank_multi(k, jnp.asarray(a), jnp.asarray(b),
                                       cfg.nt, cfg.nr, mob.admm,
                                       ladder_m=ladder_m).x
        solver.cc_frac = mob.admm.cc_frac

    takes_ladder_m = _solver_takes_ladder_m(solver)
    m_budget = mob.m_init
    window: List[int] = []
    errors = np.zeros(n_windows)
    budgets = np.zeros(n_windows, np.int64)
    estimates = np.zeros((n_windows, n), np.complex128)

    for t in range(n_windows):
        budgets[t] = m_budget
        start = t * p
        # a window contributes at most p - 1 of its own p probes so a
        # held-out remainder ALWAYS exists for the prediction score — the
        # reference's semantics (score on probes M+1..P, ref :133-163)
        # presume m_max < P (ref :112-115); scoring in-sample on the very
        # probes just solved would sit at the solver's residual floor and
        # spuriously shrink the budget.  (The old jnp gather also silently
        # CLAMPED out-of-range indices when m_budget > p.)
        m_used = min(m_budget, p - 1) if p > 1 else 0
        window = (window + list(range(start, start + m_used)))[-mob.max_window:]
        if static_pad:
            a_w, b_w = _pad_window(cb_rows, rss_amps, window, mob.max_window)
            lm = (_ladder_m_for_window(len(window), mob.max_window, n,
                                       _solver_cc_frac(solver,
                                                       mob.admm.cc_frac))
                  if takes_ladder_m else None)
        else:
            idx = np.asarray(window)
            a_w, b_w = cb_rows[idx], rss_amps[idx]
            lm = None
        kw = {"ladder_m": lm} if lm is not None else {}
        h = np.asarray(solver(jax.random.fold_in(key, t), a_w, b_w, **kw))
        estimates[t] = h

        test = np.arange(start + m_used, start + p)   # nonempty by m_used cap
        rss_eval = np.abs(cb_rows[test] @ h)
        err = _relative_rss_error(rss_eval, rss_amps[test])
        errors[t] = err
        if err < mob.threshold:
            m_budget = max(0, m_budget - m_budget // 5 - 1)
        else:
            m_budget = min(mob.m_max, m_budget + m_budget // 5 + 1)
    return MobilityTrace(rss_error=errors, probe_budget=budgets,
                        estimates=estimates)
