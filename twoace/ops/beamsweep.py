"""Sector-level-sweep baseline (802.11ad SLS) with fine angle refinement.

JAX rewrite of ``MyBeamSweeping``
(ref: main/src/evaluate_plot_results/MyBeamSweeping.m:81-159): probe a
directional beam grid, pick the argmax-RSS (f, w) pair, then refine the
AoD/AoA estimate by scanning the winning beam's pattern on a fine angle
grid (the reference uses 0.005 deg steps, ref :134).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig
from ..models.steering import steering_vector
from ..sensing.codebooks import directional_beams_angular


class SweepResult(NamedTuple):
    f_best: jax.Array      #: (nt,) winning precoder
    w_best: jax.Array      #: (nr,) winning combiner
    aod_deg: jax.Array     #: refined AoD estimate
    aoa_deg: jax.Array     #: refined AoA estimate
    rss: jax.Array         #: (mt*mr,) the measured sweep


def _refine(beam, n: int, k_d: float, step_deg: float):
    """argmax_theta |beam^H a(theta)| over a fine grid (ref :134-153)."""
    angles = jnp.arange(-90.0, 90.0 + step_deg / 2, step_deg)
    a = steering_vector(jnp.sin(jnp.deg2rad(angles)), n, k_d)
    gain = jnp.abs(jnp.einsum("t,gt->g", jnp.conj(beam), a))
    return angles[jnp.argmax(gain)]


@partial(jax.jit, static_argnames=("cfg", "mt", "mr", "step_deg", "refine"))
def beam_sweep(measure_fn_output, f_set, w_set, cfg: ArrayConfig,
               mt: int, mr: int, step_deg: float = 0.05,
               refine: bool = True) -> SweepResult:
    """Pick the best (f, w) pair from sweep measurements and refine angles.

    ``measure_fn_output``: (mt*mr,) measured |y|^2 over the beam grid in
    Tx-major order; ``f_set``: (nt, mt); ``w_set``: (nr, mr).
    """
    p = jnp.argmax(measure_fn_output)
    ind_f = p // mr
    ind_w = p % mr
    f_best = f_set[:, ind_f]
    w_best = w_set[:, ind_w]
    if refine:
        aod = _refine(f_best, cfg.nt, cfg.k_d, step_deg)
        aoa = _refine(w_best, cfg.nr, cfg.k_d, step_deg)
    else:
        aod = jnp.asarray(0.0)
        aoa = jnp.asarray(0.0)
    return SweepResult(f_best=f_best, w_best=w_best, aod_deg=aod,
                       aoa_deg=aoa, rss=measure_fn_output)


def sweep_channel(key, vec_h, cfg: ArrayConfig, mt: int, mr: int,
                  aod_range: Tuple[float, float],
                  aoa_range: Tuple[float, float],
                  snr_db: float = jnp.inf) -> SweepResult:
    """End-to-end SLS on a synthetic channel: build the directional grid,
    measure |w^H H f|^2, sweep (ref :89-129)."""
    f_set, w_set = directional_beams_angular(mt, mr, cfg, aod_range,
                                             aoa_range)
    fw = jnp.einsum("ti,rj->ijtr", f_set, jnp.conj(w_set)) \
        .reshape(mt * mr, cfg.n)
    y = fw @ jnp.asarray(vec_h, fw.dtype)
    power = jnp.abs(y) ** 2
    if jnp.isfinite(snr_db):
        noise = 10.0 ** (-snr_db / 10.0)
        power = power + noise * jax.random.exponential(key, power.shape)
    return beam_sweep(power, f_set, w_set, cfg, mt, mr)


@partial(jax.jit, static_argnames=("m", "n_runs"))
def subset_sweep_rss(key, rss_matrix, m: int, n_runs: int = 10000):
    """Expected best RSS of sector sweeping with an m-beam random subset.

    ref: main/show_beamforming_data.m:42-49 (beam_sweeping) — draw ``m`` of
    the ``total`` sweep beams (the same subset on both link ends), take the
    max RSS of the induced submatrix, and average over ``n_runs`` draws.
    ``rss_matrix``: (total, total) sweep RSS grid.
    """
    rss_matrix = jnp.asarray(rss_matrix)
    total = rss_matrix.shape[0]

    def one(k):
        idx = jax.random.choice(k, total, (m,), replace=False)
        return jnp.max(rss_matrix[jnp.ix_(idx, idx)])

    return jnp.mean(jax.vmap(one)(jax.random.split(key, n_runs)))


def aggregate_beamforming(rss_bf, rss_sweep_phi=None, rss_sweep_theta=None,
                          m_grid=None, key=None, n_runs: int = 10000):
    """Aggregate on-air beamforming results into the per-M comparison table.

    ref: main/show_beamforming_data.m:19-38 — per probe budget M: the best
    exhaustive-sweep RSS (column 1, averaged over the grid), the simulated
    random-subset sector sweeps for the phi / theta+phi codebooks (columns
    2-3), and each method's best measured beam RSS.

    ``rss_bf``: {method: (n_m,) or (repeats, n_m)} measured beam RSS;
    returns {method/baseline: (n_m,) np.ndarray}.
    """
    out = {}
    n_m = len(m_grid) if m_grid is not None else \
        len(next(iter(rss_bf.values())))
    if key is None:
        key = jax.random.PRNGKey(0)
    for name, vals in rss_bf.items():
        vals = np.asarray(vals)
        out[name] = vals.max(axis=0) if vals.ndim == 2 else vals
    for name, sweep in (("sweep_phi", rss_sweep_phi),
                        ("sweep_theta_phi", rss_sweep_theta)):
        if sweep is None:
            continue
        sweep = jnp.asarray(sweep)
        col = []
        for i, m in enumerate(m_grid[:n_m]):
            m_eff = int(min(m, sweep.shape[0]))
            col.append(float(subset_sweep_rss(
                jax.random.fold_in(key, i), sweep, m_eff, n_runs)))
        out[name] = np.asarray(col)
    return out
