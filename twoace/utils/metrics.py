"""Evaluation metrics (the reference's L6 evaluation layer).

JAX rewrite of:
  - ``Evaluation_Recovery`` (AoD/AoA errors, array-response MSE, phase-aligned
    channel NMSE)  ref: main/src/evaluate_plot_results/Evaluation_Recovery.m:73-335
  - ``Evaluate_H`` (direct-H NMSE, projection-invariant form)
    ref: main/src/evaluate_plot_results/Evaluate_H.m:1-23
  - ``Evaluate_rss`` (RSS-prediction error driving mobility re-probing)
    ref: main/src/evaluate_plot_results/Evaluate_rss.m:1-7
  - ``Evaluate_simu_rss`` (beamforming gain under SVD analog/digital BF)
    ref: main/src/evaluate_plot_results/Evaluate_simu_rss.m:1-43

All functions are pure, jittable, and batched over a leading U axis where it
makes sense.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import ArrayConfig
from ..models.steering import steering_vector, unvec_channel, virtual_grid


def phase_align(x_est, x_ref):
    """Globally phase-align ``x_est`` to ``x_ref``.

    ``phaseFac = exp(1j*angle(<x_est, x_ref> / <x_ref, x_ref>))``
    ref: Evaluation_Recovery.m:207-208.
    """
    inner = jnp.sum(jnp.conj(x_est) * x_ref, axis=-1, keepdims=True)
    denom = jnp.sum(jnp.conj(x_ref) * x_ref, axis=-1, keepdims=True)
    fac = jnp.exp(1j * jnp.angle(inner / denom))
    return x_est * fac


def nmse_h(vec_h_est, vec_h_true):
    """Phase-aligned Frobenius NMSE of the channel (ref: Evaluate_H.m:8-12)."""
    est = phase_align(vec_h_est, vec_h_true)
    err = jnp.sum(jnp.abs(est - vec_h_true) ** 2, axis=-1)
    ref = jnp.sum(jnp.abs(vec_h_true) ** 2, axis=-1)
    return err / ref


def nmse_h_projection(vec_h_est, vec_h_true):
    """Projection-invariant NMSE ``|x_gt - (x'x_gt/x'x) x|^2 / |x_gt|^2``.

    Invariant to any complex scaling of the estimate (ref: Evaluate_H.m:14-16).
    """
    xx = jnp.sum(jnp.conj(vec_h_est) * vec_h_est, axis=-1)
    xg = jnp.sum(jnp.conj(vec_h_est) * vec_h_true, axis=-1)
    coeff = (xg / jnp.maximum(jnp.abs(xx), 1e-30))[..., None]
    err = jnp.sum(jnp.abs(vec_h_true - coeff * vec_h_est) ** 2, axis=-1)
    ref = jnp.sum(jnp.abs(vec_h_true) ** 2, axis=-1)
    return err / ref


def nmse_db(nmse):
    return 10.0 * jnp.log10(nmse)


def rss_prediction_error(vec_h_est, cb_test, rss_test):
    """``mean(| |cb*H| - rss | / rss)`` — drives mobility re-probing.

    ref: Evaluate_rss.m:1-7.  ``cb_test``: (M, n); ``rss_test``: (M,) linear
    amplitudes.
    """
    rss_eval = jnp.abs(cb_test @ vec_h_est)
    return jnp.mean(jnp.abs(rss_eval - rss_test) / rss_test)


class AngleEstimate(NamedTuple):
    aod_deg: jax.Array   #: (U, L) estimated AoD, sorted descending
    aoa_deg: jax.Array   #: (U, L) estimated AoA (paired with sorted AoD)
    aod_err: jax.Array   #: (U,) mean |AoD error| vs true (degrees)
    aoa_err: jax.Array   #: (U,) mean |AoA error| vs true (degrees)
    aoda_err: jax.Array  #: (U,) mean of both


def angles_from_sparse(z_rec, cfg: ArrayConfig, tx_window, rx_window,
                       n_paths: int):
    """Top-L support of the recovered sparse vector -> AoD/AoA in degrees.

    ref: Evaluation_Recovery.m:85-126.  ``z_rec``: (U, P) with
    P = |tx_window| * |rx_window| and Rx index fastest.
    """
    n_v = len(rx_window)
    mag = jnp.abs(z_rec)
    _, idx = jax.lax.top_k(mag, n_paths)                    # (U, L)
    ind_u = idx // n_v
    ind_v = idx % n_v

    grid_t = jnp.asarray(virtual_grid(cfg.grid_t), mag.dtype)
    grid_r = jnp.asarray(virtual_grid(cfg.grid_r), mag.dtype)
    tx_w = jnp.asarray(np.asarray(tx_window))
    rx_w = jnp.asarray(np.asarray(rx_window))
    aod = jnp.rad2deg(jnp.arcsin(grid_t[tx_w[ind_u]]))
    aoa = jnp.rad2deg(jnp.arcsin(grid_r[rx_w[ind_v]]))
    return aod, aoa


def sparse_projection_omp(vec_h, ad, n_paths: int):
    """Project an H-domain estimate onto the sparse dictionary: dense z with
    an ``n_paths``-column OMP support such that ``vec_h ~= AD z``.

    Gives direct vec-H solvers (the A2 family) the same AoD/AoA readout the
    sparse-domain baselines get from their z (Evaluation_Recovery.m:85-126
    reads angles off the top-L support) — the reference never needed this
    because its angle figures only ran z-domain methods.  Gram-free on
    purpose: the dictionary can have P ~ G^2 columns and an n x n Gram at
    P = 5625 is 250 MB; with L <= a few paths the step-wise products are
    O(L P n).

    ``vec_h``: (n,) complex; ``ad``: (n, P).  Returns dense (P,) z.
    """
    n, p = ad.shape
    resid = vec_h
    sel = jnp.zeros((n_paths,), jnp.int32)
    for t in range(n_paths):                     # static, tiny
        corr = jnp.abs(jnp.conj(ad.T) @ resid)   # (P,)
        # exclude already-selected columns (one-hot mask of sel[:t])
        if t:
            taken = jnp.zeros((p,), bool).at[sel[:t]].set(True)
            corr = jnp.where(taken, -1.0, corr)
        sel = sel.at[t].set(jnp.argmax(corr).astype(jnp.int32))
        cols = ad[:, sel[:t + 1]]                # (n, t+1) gather
        g = jnp.conj(cols.T) @ cols + 1e-12 * jnp.eye(t + 1, dtype=ad.dtype)
        coef = jnp.linalg.solve(g, jnp.conj(cols.T) @ vec_h)
        resid = vec_h - cols @ coef
    z = jnp.zeros((p,), ad.dtype)
    return z.at[sel].set(coef)


def angle_error(aod_est, aoa_est, aod_true, aoa_true) -> AngleEstimate:
    """Sorted-pair angle errors (ref: Evaluation_Recovery.m:128-148).

    Both estimate and truth are sorted by descending AoD before comparison.
    """
    def sort_pair(aod, aoa):
        order = jnp.argsort(-aod, axis=-1)
        return jnp.take_along_axis(aod, order, -1), \
            jnp.take_along_axis(aoa, order, -1)

    aod_e, aoa_e = sort_pair(aod_est, aoa_est)
    aod_t, aoa_t = sort_pair(aod_true, aoa_true)
    aod_err = jnp.mean(jnp.abs(aod_e - aod_t), axis=-1)
    aoa_err = jnp.mean(jnp.abs(aoa_e - aoa_t), axis=-1)
    return AngleEstimate(aod_deg=aod_e, aoa_deg=aoa_e, aod_err=aod_err,
                         aoa_err=aoa_err, aoda_err=0.5 * (aod_err + aoa_err))


def array_response_mse(aod_est, aoa_est, aod_true, aoa_true, cfg: ArrayConfig):
    """MSE between true and estimated array-response (steering) matrices.

    ref: Evaluation_Recovery.m:166-200.
    """
    a_tx_t = steering_vector(jnp.sin(jnp.deg2rad(aod_true)), cfg.nt, cfg.k_d)
    a_rx_t = steering_vector(jnp.sin(jnp.deg2rad(aoa_true)), cfg.nr, cfg.k_d)
    a_tx_e = steering_vector(jnp.sin(jnp.deg2rad(aod_est)), cfg.nt, cfg.k_d)
    a_rx_e = steering_vector(jnp.sin(jnp.deg2rad(aoa_est)), cfg.nr, cfg.k_d)

    def fro2(x):
        return jnp.sum(jnp.abs(x) ** 2, axis=(-2, -1))

    mse_t = fro2(a_tx_t - a_tx_e) / fro2(a_tx_t)
    mse_r = fro2(a_rx_t - a_rx_e) / fro2(a_rx_t)
    return 0.5 * (mse_t + mse_r)


def quantize_ps(w, phase_bit: int):
    """Nearest-phase 2^b-PSK quantization with 1/sqrt(rows) magnitude.

    ref: main/src/generate_sensing_matrix/Quantize_PS.m:61-73 — grid
    ``-pi : 2*pi/2^b : pi`` (note: includes both endpoints; -pi and pi map to
    the same phasor).
    """
    nps = 2 ** phase_bit
    rows = w.shape[-2]
    grid = jnp.arange(-nps // 2, nps // 2 + 1) * (2.0 * np.pi / nps)
    ang = jnp.angle(w)
    idx = jnp.argmin(jnp.abs(ang[..., None] - grid), axis=-1)
    return jnp.exp(1j * grid[idx]).astype(w.dtype) / np.sqrt(rows)


def beamforming_gain(vec_h_est, h_true, cfg: ArrayConfig) -> Tuple[jax.Array, jax.Array]:
    """Signal strength under SVD analog (2-bit) and digital beamforming.

    From the *estimated* channel, compute the dominant left/right singular
    vectors, constant-modulus-project (+quantize) them, and apply to the
    *true* channel.  ref: Evaluate_simu_rss.m:32-40.

    Returns (analog_gain, digital_gain), each shaped like the batch.
    """
    h_est = unvec_channel(vec_h_est, cfg.nr, cfg.nt)
    u, _, vh = jnp.linalg.svd(h_est, full_matrices=False)
    w_dig = jnp.exp(1j * jnp.angle(u[..., :, 0])) / np.sqrt(cfg.nr)
    f_dig = jnp.exp(1j * jnp.angle(jnp.conj(vh[..., 0, :]))) / np.sqrt(cfg.nt)
    w_ana = quantize_ps(w_dig[..., None], cfg.phase_bit)[..., 0]
    f_ana = quantize_ps(f_dig[..., None], cfg.phase_bit)[..., 0]

    def gain(w, f):
        return jnp.abs(jnp.einsum("...r,...rt,...t->...", jnp.conj(w),
                                  h_true, f))

    return gain(w_ana, f_ana), gain(w_dig, f_dig)
