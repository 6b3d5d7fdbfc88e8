"""Proximal operators of the 2ACE ADMM family.

JAX rewrites of the three prox steps of the reference solver:
  - magnitude projection (ArgMinY)
    ref: inferLowRankV4_multi.m:511-533 (and normalize_rows :538-559)
  - spectral-profile low-rank prox (ArgMinZ) — the 2ACE novelty
    ref: inferLowRankV4_multi.m:423-485
  - nuclear-norm SVD soft-threshold prox
    ref: inferLowRank_Nuclear.m:411-439

All operators are pure, jittable, batched-friendly, and built on small-matrix
Gram eigendecompositions (:mod:`..ops.eigh_jacobi`) instead of host SVD.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax.numpy as jnp

from .eigh_jacobi import eigh_desc


def magnitude_prox(ax, b, m_dual, mu, scale_by_row: bool):
    """ArgMinY: project Y = AX + M/mu toward the measured magnitudes B.

    R = (B + mu*D) / (1 + mu) with D the current magnitude; direction kept.
    ref: inferLowRankV4_multi.m:511-533.

    ``ax``: (m, r) complex; ``b``: (m,) real; ``m_dual``: (m, r).
    """
    y = ax + m_dual / mu
    # rows with b == 0 are INACTIVE (static-shape window padding): their
    # exact prox is y = 0 (see cplx.magnitude_prox_rows); real measured
    # amplitudes are strictly positive, so this is inert otherwise
    active = b[..., None] > 0
    if scale_by_row:
        d = jnp.sqrt(jnp.sum(jnp.abs(y) ** 2, axis=-1, keepdims=True))
        r = y.shape[-1]
        y = jnp.where(d == 0, (1.0 / math.sqrt(r)) + 0j, y)
        d = jnp.where(d == 0, 1.0, d)
        bd = b[..., None] / d
        return y * ((bd + mu) / (1.0 + mu) * active).astype(y.dtype)
    d = jnp.abs(y)
    y = jnp.where(d == 0, 1.0 + 0j, y)
    d = jnp.where(d == 0, 1.0, d)
    bd = b[..., None] / d
    return y * ((bd + mu) / (1.0 + mu) * active).astype(y.dtype)


def project_rows_to_magnitude(y, b, scale_by_row: bool):
    """normalize_rows: set row magnitudes of Y exactly to B (mu -> inf limit).

    ref: inferLowRankV4_multi.m:538-559.
    """
    if scale_by_row:
        d = jnp.sqrt(jnp.sum(jnp.abs(y) ** 2, axis=-1, keepdims=True))
        r = y.shape[-1]
        y = jnp.where(d == 0, (1.0 / math.sqrt(r)) + 0j, y)
        d = jnp.where(d == 0, 1.0, d)
        return y * (b[..., None] / d).astype(y.dtype)
    d = jnp.abs(y)
    y = jnp.where(d == 0, 1.0 + 0j, y)
    d = jnp.where(d == 0, 1.0, d)
    return y * (b[..., None] / d).astype(y.dtype)


def profile_ladder(nt: int, nr: int, m: int, n: int, use_rank_one: bool,
                   rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                   fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                   mode: str = "v4") -> Tuple[Tuple[int, float], ...]:
    """Static constraint-ladder selection C(r, f).

    ref: inferLowRankV4_multi.m:437-464.  The choice depends only on static
    shape information, so it is resolved at trace time.

    ``mode`` selects the historical solver generation:
      - ``"v1"``: single constraint (ceil(sqrt(sz)), f2)
        (ref: inferLowRank.m:407-418)
      - ``"v2"``: v1 + the m >= 3n overdetermined case and rank-1 mode
        (ref: inferLowRankV2.m:407-431); also used by V3, which only
        re-parameterizes mu0/rho/cc_frac (ref: inferLowRankV3.m:4-9)
      - ``"v4"``: the full constraint ladder with small-size fallbacks
    """
    sz = min(nt, nr)
    rs = [math.ceil(math.sqrt(sz) * rank_mults[0]),
          math.ceil(math.sqrt(sz) * rank_mults[1]),
          math.ceil(math.sqrt(sz) * rank_mults[2]),
          min(sz, math.ceil(math.sqrt(sz) * rank_mults[3]))]
    fs = list(fractions)
    if mode == "v1":
        return ((rs[2], fs[2]),)
    if use_rank_one:
        return ((1, 0.95),)
    if m >= 3 * n:
        return ((rs[3], fs[3]),)
    if mode == "v2":
        return ((rs[2], fs[2]),)
    if rs[1] <= 2:
        return ((rs[2], fs[2]),)
    if rs[0] <= 2:
        return tuple(zip(rs[1:], fs[1:]))
    return tuple(zip(rs, fs))


def profile_ladder_arrays(nt: int, nr: int, m: int, n: int,
                          use_rank_one: bool,
                          rank_mults: Sequence[float] = (0.5, 0.7, 1.0, 2.0),
                          fractions: Sequence[float] = (0.8, 0.9, 0.95, 0.995),
                          mode: str = "v4", length: int = 4):
    """The constraint ladder as fixed-length traced arrays (LadderArrays).

    Same selection logic as :func:`profile_ladder`, padded to ``length``
    levels with no-op entries (f = 0 never triggers a rescale).  Because
    the rank-1 and normal ladders share one shape, the solver's
    quality-gated retry / rank-one refinement flag (ref:
    inferLowRankV4_multi.m:73-77,92-100) becomes a per-instance
    ``jnp.where`` over ladder *data* instead of a second traced branch.
    """
    from .cplx import LadderArrays

    lvl = profile_ladder(nt, nr, m, n, use_rank_one, rank_mults, fractions,
                         mode=mode)
    if len(lvl) > length:
        raise ValueError(f"ladder has {len(lvl)} levels > length={length}")
    ranks = [float(rk) for rk, _ in lvl] + [float(min(nt, nr))] * (length - len(lvl))
    fracs = [float(f) for _, f in lvl] + [0.0] * (length - len(lvl))
    return LadderArrays(jnp.asarray(ranks, jnp.float32),
                        jnp.asarray(fracs, jnp.float32))


def _columns_to_panel(z, nt: int, nr: int):
    """(n, r) ADMM matrix -> (nr, nt*r) panel of per-column channel matrices.

    Column c of Z is vec(H_c) with Rx index fastest; H_c = (nr, nt).  The
    reference's ``reshape(Z, tx, [])`` (inferLowRankV4_multi.m:427) builds the
    same set of panel columns (column order differs, which is irrelevant to
    the Gram E*E').
    """
    n, r = z.shape
    # z[:, c] index k = it*nr + ir  ->  H_c[ir, it]
    h = z.T.reshape(r, nt, nr)             # (r, nt, nr); h[c, it, ir]
    e = h.transpose(2, 0, 1).reshape(nr, r * nt)
    return e


def _panel_to_columns(e, nt: int, nr: int, r: int):
    """Inverse of :func:`_columns_to_panel`."""
    h = e.reshape(nr, r, nt).transpose(1, 2, 0)   # (r, nt, nr)
    return h.reshape(r, nt * nr).T


def spectral_profile_prox(z, nt: int, nr: int,
                          ladder: Tuple[Tuple[int, float], ...],
                          eig_backend: str = "jacobi"):
    """ArgMinZ: enforce the spectral-profile constraint ladder on Z.

    For each (r, f) in the ladder, if the top-r eigenvalues of E*E' capture
    less than fraction f of the total variance, the trailing eigenvalues are
    rescaled by ``min(1, vr/(v-vr) * (1/f - 1))``; rescalings compose across
    ladder levels.  Reconstruction: Z = U diag(sqrt(scale)) U^H E.
    ref: inferLowRankV4_multi.m:423-485.

    ``z``: (n, r) complex with n = nt*nr.
    """
    n, r = z.shape
    e = _columns_to_panel(z, nt, nr)                   # (nr, nt*r)
    g = e @ jnp.conj(e.T)                              # (nr, nr) PSD Gram
    g = 0.5 * (g + jnp.conj(g.T))
    w, u = eigh_desc(g, backend=eig_backend)           # descending
    w = jnp.maximum(w, 0.0)

    scale = jnp.ones_like(w)
    v_tot = jnp.sum(w)
    for rk, f in ladder:
        vr = jnp.sum(w[:rk])
        need = vr < v_tot * f
        s = jnp.minimum(1.0, vr / jnp.maximum(v_tot - vr, 1e-30) * (1.0 / f - 1.0))
        s = jnp.where(need, s, 1.0)
        tail = jnp.arange(w.shape[0]) >= rk
        mult = jnp.where(tail, s, 1.0)
        w = w * mult
        scale = scale * mult
        v_tot = jnp.sum(w)

    # Z = E + U diag(sqrt(scale)-1) U^H E: exactly identity when scale == 1.
    coeff = (jnp.sqrt(scale) - 1.0).astype(z.dtype)
    uhe = jnp.conj(u.T) @ e
    e_new = e + u @ (coeff[:, None] * uhe)
    return _panel_to_columns(e_new, nt, nr, r)


def nuclear_prox(z, thresh, eig_backend: str = "jacobi"):
    """SVD soft-threshold of the (n, r) ADMM matrix at level ``thresh``.

    ``Z = U * max(S - thresh, 0) * V^H`` via the r x r Gram eigendecomposition
    (n >> r, so this is the thin side).  ref: inferLowRank_Nuclear.m:411-439.
    """
    n, r = z.shape
    g = jnp.conj(z.T) @ z                              # (r, r)
    g = 0.5 * (g + jnp.conj(g.T))
    w, v = eigh_desc(g, backend=eig_backend)
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    s_new = jnp.maximum(s - thresh, 0.0)
    ratio = (s_new / jnp.maximum(s, 1e-30)).astype(z.dtype)
    return z @ (v * ratio[None, :]) @ jnp.conj(v.T)
