"""Bayesian A-optimal beam (row) selection.

JAX rewrite of the reference's row-exchange A-optimality minimization
with rank-1 Sherman-Morrison updates:
  ref: main/src/bayes_opt/bayesAopt_complex.m:105-240 (core loop :187-229)
  ref: main/src/bayes_opt/MyBayesAopt.m:1-231 (multi-user criterion :166-170)
  ref: main/src/generate_sensing_matrix/Bayes_Beam.m:1-15 (candidate draw)

Objective: choose M rows X out of a candidate set C to minimize the
(multi-user) Bayesian A-criterion ``sum_u trace(A * inv(X'X + K_u))``
(A = weight matrix, K_u = per-user prior precision).  The greedy exchange
removes one design row, evaluates the trace delta of adding every candidate
via Sherman-Morrison, and keeps the best swap when it improves the criterion
beyond ``-sqrt(eps)`` (ref: MyBayesAopt.m:201 ``a < acutoff``) or the slot has
never been placed.

Notes: the per-row step is U batched (n, n) x (n, C) matmuls, and the whole selection is one jitted ``lax.fori_loop``; the
user axis is a leading vmap-style array axis.  The reference applies
Sherman-Morrison updates to the *summed* inverse (MyBayesAopt.m:166-170),
which is only approximate for U > 1; here each user's inverse is updated
exactly and the criterion deltas are summed — same objective, exact algebra.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


@partial(jax.jit, static_argnames=("m", "sweeps"))
def bayes_a_opt_select(key, candidates, m: int, prior_k=None,
                       weight_a=None, sweeps: int = 2):
    """Select ``m`` row indices from ``candidates`` (C, n).

    ``prior_k``: prior precision K, shape (n, n), or a stack (U, n, n) for
    the multi-user criterion (default I, as used by Bayes_Beam.m:13);
    ``weight_a``: A-criterion weight (default I).
    Returns int32 indices of shape (m,).
    """
    cand = jnp.asarray(candidates)
    c_count, n = cand.shape
    dtype = cand.dtype
    if prior_k is None:
        prior_k = jnp.eye(n, dtype=dtype)
    else:
        prior_k = jnp.asarray(prior_k, dtype)
    if prior_k.ndim == 2:
        prior_k = prior_k[None]          # single user == U = 1
    if weight_a is None:
        weight_a = jnp.eye(n, dtype=dtype)
    else:
        weight_a = jnp.asarray(weight_a, dtype)
    acutoff = -jnp.sqrt(jnp.finfo(cand.real.dtype).eps)

    # random initial design (ref: bayesAopt_complex.m:127-128); a slot is
    # "placed" once the exchange loop has committed it (MyBayesAopt.m:201).
    rowlist = jax.random.randint(key, (m,), 0, c_count)
    x0 = cand[rowlist]
    gram = jnp.conj(x0.T) @ x0
    minv = jax.vmap(lambda k: jnp.linalg.inv(gram + k))(prior_k)  # (U, n, n)
    placed = jnp.zeros((m,), bool)
    ch = jnp.conj(cand)

    def step(i, carry):
        minv, rowlist, placed = carry
        row = i % m
        x = cand[rowlist[row]]
        # remove row, per user: Ninv_u = Minv_u + w_u u_u u_u^H (ref :145-146)
        u = jnp.einsum("unp,p->un", minv, x)                       # (U, n)
        w = 1.0 / jnp.maximum(
            jnp.real(1.0 - jnp.einsum("n,un->u", jnp.conj(x), u)), 1e-12)
        ninv = minv + w[:, None, None] * jnp.einsum(
            "un,up->unp", u, jnp.conj(u))
        # removal delta: +sum_u w_u u_u^H A u_u  (ref: MyBayesAopt.m:162-163)
        au = jnp.einsum("np,up->un", weight_a, u)
        removal = jnp.sum(w * jnp.real(jnp.einsum("un,un->u", jnp.conj(u), au)))
        # addition deltas for every candidate (ref :166-171):
        #   trace(A (Ninv - w_i u_i u_i^H)) = trace(A Ninv) - w_i u_i^H A u_i
        u_all = jnp.einsum("unp,cp->unc", ninv, cand)              # (U, n, C)
        denom = 1.0 + jnp.real(jnp.einsum("cn,unc->uc", ch, u_all))
        w_all = 1.0 / jnp.maximum(denom, 1e-12)                    # (U, C)
        au_all = jnp.einsum("np,upc->unc", weight_a, u_all)
        quad = jnp.real(jnp.einsum("unc,unc->uc", jnp.conj(u_all), au_all))
        delta = removal - jnp.sum(w_all * quad, axis=0)            # (C,)
        idx = jnp.argmin(delta)
        # commit only when it improves or the slot was never placed
        # (ref: MyBayesAopt.m:201 ``(a < acutoff) || (rowlist(row) == 0)``)
        take = (delta[idx] < acutoff) | ~placed[row]
        u_i = u_all[:, :, idx]
        w_i = w_all[:, idx]
        minv_new = ninv - w_i[:, None, None] * jnp.einsum(
            "un,up->unp", u_i, jnp.conj(u_i))
        minv = jnp.where(take, minv_new, minv)
        rowlist = rowlist.at[row].set(
            jnp.where(take, idx.astype(rowlist.dtype), rowlist[row]))
        placed = placed.at[row].set(True)
        return (minv, rowlist, placed)

    minv, rowlist, _ = lax.fori_loop(0, sweeps * m, step,
                                     (minv, rowlist, placed))
    return rowlist


def prior_from_channel(h_matrix, cfg, n_grid: int,
                       aod_range=(-47.5, 47.5)):
    """Diagonal prior K from a channel estimate: K_ii = |H w(theta_i)|^{-1/2}.

    ref: main/src/bayes_opt/find_K.m:1-13.
    """
    from ..models.steering import steering_vector

    aod = jnp.linspace(aod_range[0], aod_range[1], n_grid)
    w = steering_vector(jnp.sin(jnp.deg2rad(aod)), cfg.nt, cfg.k_d)  # (g, nt)
    gain = jnp.abs(jnp.einsum("rt,gt->gr", h_matrix, w))
    vec_k = jnp.sqrt(jnp.mean(gain, axis=-1)) ** -1.0
    return jnp.diag(vec_k.astype(jnp.complex64))


def noise_prior_from_vech(vec_h_users, snr_db: float):
    """Per-user diagonal prior ``K_u = db2pow(SNR) * diag(vecH_u ^ -1)``.

    ref: main/src/generate_sensing_matrix/Directional_Beam_Bayes.m:41-48.
    """
    vh = jnp.asarray(vec_h_users)
    if vh.ndim == 1:
        vh = vh[None]
    scale = 10.0 ** (snr_db / 10.0)
    inv = scale / jnp.where(jnp.abs(vh) > 1e-30, vh, 1e-30)
    return jax.vmap(jnp.diag)(inv)
