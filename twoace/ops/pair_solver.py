"""The full 2ACE "A2" solver in pair (re, im) representation — the
production accelerator path.

:mod:`.admm` implements the solver family with complex dtypes (the
CPU/parity stack).  This module re-expresses the *entire*
``inferLowRankV4_multi`` scaffold — spectral init, over-parameterized ADMM
with best-so-far tracking and residual convergence, column
orthonormalization, restarts, quality-gated rank-1 fallback, full-data
refinement with similarity rollback (ref:
main/src/my_recovery_algorithms/ADMM_v2/inferLowRankV4_multi.m:5-109) —
in the transposed (r-leading) pair layout of
:func:`.cplx.admm_iteration_pair_t`:

  - all state arrays carry the over-parameterization axis r first, so the
    contiguous (minor) dimension of every matmul is n or m, never the
    thin r, see ``admm_iteration_pair_t`` for the layout rationale;
  - Hermitian eigenproblems run on the real symmetric embedding
    ``[[Hr, -Hi], [Hi, Hr]]`` (Jacobi for the in-loop Z-prox Gram,
    Cholesky/orthogonal-iteration for the one-time precomputes);
  - data-dependent control flow (convergence, mu adaptation, rank-1 retry,
    rollback) is ``lax.while_loop`` carry state and ``lax.cond`` branches,
    identical in structure to the complex path.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import AdmmConfig
from .cplx import (
    Pair,
    add,
    conj,
    embed_hermitian,
    eigh_update_perturbative,
    magnitude_prox_cols,
    matmul,
    unembed,
)
from .eigh_jacobi import eigh_jacobi
from .cplx import LadderArrays
from .prox import profile_ladder, profile_ladder_arrays


class PairAdmmResult(NamedTuple):
    x: Pair               #: (n,) recovered vec(H) as a pair
    quality: jax.Array    #: held-out quality 1 - ||(|A x|) - b|| / ||b||
    converged: jax.Array  #: bool
    #: total inner-ADMM iterations whose results were used (sum of the
    #: while-loop trip counts of every InferADMM solve on the selected
    #: cond branches).  Under vmap both cond branches execute physically,
    #: so per-chip iteration-rate estimates derived from this are
    #: conservative.  ref iteration budget: inferLowRankV4_multi.m:13,42,89.
    # NOTE: plain-int default, NOT jnp.asarray(0): a device-array default
    # would be materialized at import time and initialize the XLA backend,
    # which breaks jax.distributed.initialize (must run before any backend
    # use) for multi-host users importing this package.
    iters: "jax.Array | int" = 0


# ---------------------------------------------------------------------------
# small pair helpers (transposed layout: matrices are (r, n) / (r, m))

def _t(p: Pair) -> Pair:
    return Pair(jnp.swapaxes(p.re, -1, -2), jnp.swapaxes(p.im, -1, -2))


def _fro2(p: Pair):
    return jnp.sum(p.re * p.re + p.im * p.im)


def _norm(p: Pair):
    return jnp.sqrt(_fro2(p))


def _scale(p: Pair, s) -> Pair:
    return Pair(p.re * s, p.im * s)


def _sub(a: Pair, b: Pair) -> Pair:
    return Pair(a.re - b.re, a.im - b.im)


def _zeros(shape) -> Pair:
    return Pair(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


def precompute_u_pair(a: Pair, reg: float = 1.0) -> Pair:
    """U = inv(A^H A + reg I) as a pair, via the real symmetric embedding.

    The embedding is an algebra isomorphism, so inv(embed(G)) = embed(inv(G));
    a real Cholesky factorization + triangular solves of the (2n, 2n)
    embedding recover the complex inverse.  ref: inferLowRankV4_multi.m:241-247.
    """
    n = a.shape[-1]
    g = matmul(_t(conj(a)), a)                                   # A^H A
    g = Pair(0.5 * (g.re + g.re.T) + reg * jnp.eye(n, dtype=jnp.float32),
             0.5 * (g.im - g.im.T))
    g_emb = embed_hermitian(g)
    c = jnp.linalg.cholesky(g_emb)
    eye = jnp.eye(2 * n, dtype=jnp.float32)
    w = jax.scipy.linalg.solve_triangular(c, eye, lower=True)
    return unembed(w.T @ w, n)


def _cholqr(z):
    """Orthonormalize columns of real ``z`` by two rounds of Cholesky-QR
    (matmul + Cholesky + triangular solve only — no Householder QR)."""
    for _ in range(2):
        g = z.T @ z
        g = g + 1e-7 * jnp.trace(g) / g.shape[0] * jnp.eye(
            g.shape[0], dtype=z.dtype)
        c = jnp.linalg.cholesky(g)
        z = jax.scipy.linalg.solve_triangular(c, z.T, lower=True).T
    return z


def spectral_initialize_pair(a: Pair, b, r: int, key=None,
                             iters: int = 12) -> Pair:
    """Transposed-layout spectral init: X0^T of shape (r, n).

    OI depth 12 (was 24): an interleaved on-chip A/B at batch 256 showed
    identical selected-iteration counts and end accuracy (987 iters/inst,
    -94.7 dB median, min quality 1.0) at both depths — the ADMM restarts
    absorb init residual — while 12 steps buy +4.8% end-to-end
    recoveries/s (99.8 vs 95.2, walls 2.56+-0.02 vs 2.69+-0.02 s).

    Rows of A are scaled by b_i/||A_i||; the top-r eigenpairs of the scaled
    Gram (computed by orthogonal iteration on the real 2n x 2n embedding,
    Cholesky-QR orthonormalization) are scaled by sqrt(eigenvalue).
    ref: inferLowRankV4_multi.m:561-574.  Embedded eigenvectors [vr; vi]
    map back to complex eigenvectors vr + i*vi; the embedding duplicates
    every eigenvalue, so the iteration runs at width 2r and keeps every
    other Ritz vector.
    """
    m, n = a.shape
    r = min(r, m, n)
    row_norm = jnp.sqrt(jnp.maximum(
        jnp.sum(a.re * a.re + a.im * a.im, axis=-1), 1e-30))
    s = jnp.where(row_norm > 1e-15, b / row_norm, 1.0)
    a_s = Pair(a.re * s[:, None], a.im * s[:, None])
    g = matmul(_t(conj(a_s)), a_s)
    g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
    g_emb = embed_hermitian(g)                                   # (2n, 2n)

    if key is None:
        key = jax.random.PRNGKey(17)
    q = jax.random.normal(key, (2 * n, 2 * r), jnp.float32)

    def body(q, _):
        return _cholqr(g_emb @ q), None

    q, _ = lax.scan(body, _cholqr(q), None, length=iters)
    rr = q.T @ (g_emb @ q)
    rr = 0.5 * (rr + rr.T)
    w, v = eigh_jacobi(rr)                                       # descending
    ritz = q @ v                                                 # (2n, 2r)
    w = jnp.maximum(w[0::2], 0.0)                                # dedup pairs
    vecs = ritz[:, 0::2]                                         # (2n, r)
    x0 = Pair(vecs[:n, :], vecs[n:, :])                          # complex cols
    x0 = Pair(x0.re * jnp.sqrt(w)[None, :], x0.im * jnp.sqrt(w)[None, :])
    return _t(x0)                                                # (r, n)


def project_cols_to_magnitude(y: Pair, b, scale_by_row: bool) -> Pair:
    """Transposed-layout ``normalize_rows``: set the per-measurement
    magnitude of Y (r, m) exactly to b (m,).  ref: inferLowRankV4_multi.m:538-559.
    """
    if scale_by_row:
        d2 = jnp.sum(y.re * y.re + y.im * y.im, axis=-2, keepdims=True)
        r = y.shape[-2]
        zero = d2 <= 0
        yr = jnp.where(zero, 1.0 / math.sqrt(r), y.re)
        yi = jnp.where(zero, 0.0, y.im)
        d = jnp.sqrt(jnp.where(zero, 1.0, d2))
        c = b[..., None, :] / d
        return Pair(yr * c, yi * c)
    d2 = y.re * y.re + y.im * y.im
    zero = d2 <= 0
    yr = jnp.where(zero, 1.0, y.re)
    yi = jnp.where(zero, 0.0, y.im)
    d = jnp.sqrt(jnp.where(zero, 1.0, d2))
    c = b[..., None, :] / d
    return Pair(yr * c, yi * c)


def magnitude_prox_cols_elem(ax: Pair, b, m_dual: Pair, mu) -> Pair:
    """Transposed-layout elementwise magnitude prox (scale_by_row=False):
    each column of X is an independent candidate, so each entry of Y is
    pulled toward |y| = b_i.  ref: inferLowRankV4_multi.m:525-533."""
    inv_mu = 1.0 / mu
    yr = ax.re + m_dual.re * inv_mu
    yi = ax.im + m_dual.im * inv_mu
    d2 = yr * yr + yi * yi
    zero = d2 <= 0
    yr = jnp.where(zero, 1.0, yr)
    d = jnp.sqrt(jnp.where(zero, 1.0, d2))
    # b == 0 rows are inactive padding -> y = 0 (see magnitude_prox_rows)
    coeff = (b[..., None, :] / d + mu) / (1.0 + mu) * (b[..., None, :] > 0)
    return Pair(yr * coeff, yi * coeff)


def _panel_maps(nt: int, nr: int, r: int):
    def to_panel(xx):
        return xx.reshape(r, nt, nr).transpose(2, 0, 1).reshape(nr, r * nt)

    def from_panel(ee):
        return ee.reshape(nr, r, nt).transpose(1, 2, 0).reshape(r, nt * nr)

    return to_panel, from_panel


def _spectral_prox_t(z: Pair, nt: int, nr: int, ladder, sweeps: int,
                     v0, eig_mode: str):
    """Transposed-layout spectral-profile prox; returns (z_new, basis).

    The whole Gram -> eigenbasis update -> constraint ladder -> delta-apply
    chain is plain JAX, fused by XLA.  ref: inferLowRankV4_multi.m:423-485.
    """
    from .cplx import _panel_spectral_prox, _panel_spectral_prox_c

    r = z.shape[-2]
    to_panel, from_panel = _panel_maps(nt, nr, r)
    e = Pair(to_panel(z.re), to_panel(z.im))
    if eig_mode == "perturb" and (v0 is None or isinstance(v0, Pair)):
        e_new, v = _panel_spectral_prox_c(e, nr, ladder, v0)
    else:
        e_new, v = _panel_spectral_prox(e, nr, ladder, sweeps, v0,
                                        eig_mode=eig_mode)
    return Pair(from_panel(e_new.re), from_panel(e_new.im)), v


def _nuclear_prox_t(z: Pair, thresh) -> Pair:
    """Transposed-layout nuclear prox: SVD soft-threshold of Z^T (n, r) via
    the r x r Gram.  ref: inferLowRank_Nuclear.m:411-439."""
    r = z.shape[-2]
    g = matmul(conj(z), _t(z))     # g_cd = sum_k conj(Z_kc) Z_kd = (Z^H Z)_cd
    g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
    w, v_emb = eigh_jacobi(embed_hermitian(g))
    s = jnp.sqrt(jnp.maximum(w[0::2], 0.0))
    ratio = jnp.maximum(s - thresh, 0.0) / jnp.maximum(s, 1e-30)
    coeff = jnp.repeat(ratio, 2)
    m_emb = (v_emb * coeff[None, :]) @ v_emb.T                   # V ratio V^H
    m_pair = unembed(m_emb, r)
    # Z_new = Z (V ratio V^H)  =>  z_new = (V ratio V^H)^T z = conj(M) z
    return matmul(conj(m_pair), z)


def _quality_pair(a_test: Pair, b_test, x: Pair):
    """1 - ||(|A_test x|) - b_test|| / ||b_test|| for single-column x
    ((n,) or (1, n)).  ref: inferLowRankV4_multi.m:68."""
    if x.re.ndim == 1:
        x = Pair(x.re[None, :], x.im[None, :])
    ax = matmul(x, _t(a_test))                                   # (1, m)
    amp = jnp.sqrt(jnp.maximum(ax.re ** 2 + ax.im ** 2, 0.0))[0]
    return 1.0 - (jnp.linalg.norm(amp - b_test)
                  / jnp.maximum(jnp.linalg.norm(b_test), 1e-30))


def infer_admm_pair(a: Pair, b, x0: Pair, *, scale_by_row: bool,
                    nt: int, nr: int,
                    ladder: Optional[Tuple[Tuple[int, float], ...]],
                    u_mat: Optional[Pair] = None,
                    prox_kind: str = "spectral_profile",
                    mu0: float = 1e-3, rho: float = 1.03,
                    tol_rel: float = 1e-4, tol_abs: float = 1e-8,
                    maxiter: int = 500, sweeps: int = 1,
                    eig_mode: str = "perturb",
                    warm_iters: int = 0,
                    anchor: Optional[Pair] = None,
                    anchor_weight: float = 0.0):
    """One InferADMM solve in transposed pair layout.

    Mirrors :func:`.admm.infer_admm` (ref: inferLowRankV4_multi.m:281-386):
    X-update against precomputed U, magnitude prox, Z-prox (spectral-profile
    ladder or nuclear soft-threshold), dual updates, best-so-far tracking,
    three-residual convergence tests, and mu adaptation.  The Z-prox
    eigenbasis is carried across iterations (``eig_mode='perturb'`` refines
    it with ~5 small matmuls per iteration; ``'jacobi'`` runs ``sweeps``
    warm Jacobi sweeps).

    Returns ``(x_t, y_t, converged)`` with x_t (r, n), y_t (r, m).
    """
    m, n = a.shape
    r = x0.shape[-2]
    has_z = ladder is not None or prox_kind == "nuclear"

    # Proximal anchor (tracking mode): adds anchor_weight*||x - anchor||^2
    # to the X-subproblem, so directions the current measurement rows do
    # not constrain stay at the anchor instead of drifting — the mechanism
    # by which the mobility tracker ACCUMULATES beam diversity across
    # sliding windows (see pipeline.mobility.make_warm_pair_solver).
    # U absorbs the extra ridge: inv(A^H A + (1 + w) I).
    anchored = anchor is not None and anchor_weight > 0.0
    if anchored and not has_z:
        raise ValueError("proximal anchor requires the Z-constrained path")
    if anchored and u_mat is not None:
        # The anchor's (1 + w) ridge lives inside U = inv(A^H A + (1+w) I);
        # a caller-provided U built with the plain unit ridge would solve
        # the wrong X-subproblem (anchor pull in the rhs, no matching
        # ridge), so require U to be derived here.
        raise ValueError("anchored solves must not pass a precomputed "
                         "u_mat; the (1 + anchor_weight) ridge is folded "
                         "into U internally")
    if u_mat is None:
        u_mat = precompute_u_pair(
            a, reg=1.0 + (anchor_weight if anchored else 0.0))
    a_conj = Pair(a.re, -a.im)                                   # (m, n)
    a_t = _t(a)                                                  # (n, m)
    u_conj = Pair(u_mat.re, -u_mat.im)                           # U^T
    if anchored:
        anc = Pair(anchor_weight * anchor.re, anchor_weight * anchor.im)

    def a_mul(x):                                                # (r,n)->(r,m)
        return matmul(x, a_t)

    def ah_mul(y):                                               # (r,m)->(r,n)
        return matmul(y, a_conj)

    def z_prox(z_in, mu, v0):
        if prox_kind == "nuclear":
            return _nuclear_prox_t(z_in, 1.0 / mu), v0
        return _spectral_prox_t(z_in, nt, nr, ladder, sweeps, v0, eig_mode)

    # --- initialization (ref :300-321) ---
    x = x0
    ax = a_mul(x)
    if scale_by_row:
        bn = jnp.linalg.norm(b)
        x = _scale(x, bn / jnp.maximum(_norm(ax), 1e-30))
    else:
        col = jnp.sqrt(jnp.maximum(
            jnp.sum(ax.re ** 2 + ax.im ** 2, axis=-1), 1e-30))   # (r,)
        x = _scale(x, (jnp.linalg.norm(b) / col)[:, None])
    ax = a_mul(x)
    y = project_cols_to_magnitude(ax, b, scale_by_row)
    aty = ah_mul(y)
    if has_z:
        # seed the warm eigenbasis with a cold Jacobi solve of the initial
        # Gram (cheap, once per solve)
        z, v_basis = z_prox(x, jnp.asarray(1.0, jnp.float32), None)
        if prox_kind == "nuclear":
            v_basis = jnp.eye(2 * nr, dtype=jnp.float32)
    else:
        z = _zeros((1, 1))
        v_basis = jnp.eye(2, dtype=jnp.float32)

    init = dict(y=y, z=z, m_dual=_zeros((r, m)),
                n_dual=_zeros((r, n)) if has_z else _zeros((1, 1)),
                aty=aty, v_basis=v_basis,
                mu=jnp.asarray(mu0, jnp.float32),
                last_res=jnp.asarray(jnp.inf, jnp.float32),
                opt_obj=jnp.asarray(jnp.inf, jnp.float32),
                opt_x=_zeros((r, n)) if scale_by_row else _zeros((n,)),
                opt_y=_zeros((r, m)) if scale_by_row else _zeros((m,)),
                it=jnp.asarray(0, jnp.int32),
                done=jnp.asarray(False), converged=jnp.asarray(False))

    def cond(c):
        return jnp.logical_and(c["it"] < maxiter, jnp.logical_not(c["done"]))

    def body(c):
        y0, z0, aty0 = c["y"], c["z"], c["aty"]
        mu = c["mu"]
        inv_mu = 1.0 / mu

        # X-update (ref :401-409); the optional proximal anchor adds its
        # weighted pull to the rhs (U already carries the matching ridge).
        # Named scopes label each stage's ops in profiler traces.
        with jax.named_scope("admm_x_update"):
            if has_z:
                t = Pair(y0.re - c["m_dual"].re * inv_mu,
                         y0.im - c["m_dual"].im * inv_mu)
                rhs = add(ah_mul(t), Pair(z0.re - c["n_dual"].re * inv_mu,
                                          z0.im - c["n_dual"].im * inv_mu))
                if anchored:
                    rhs = add(rhs, anc)
                x = matmul(rhs, u_conj)
            else:
                # (anchor unsupported here: the z-free path's u_mat is a
                # pinv, not a regularized inverse — tracking always runs
                # with Z)
                t = Pair(y0.re - c["m_dual"].re * inv_mu,
                         y0.im - c["m_dual"].im * inv_mu)
                x = matmul(t, u_conj)                            # U = pinv^T'
            ax = a_mul(x)

        # Y-update (ref :511-533) and the M-dual update (ref :336-341)
        with jax.named_scope("admm_prox_dual"):
            if scale_by_row:
                y = magnitude_prox_cols(ax, b, c["m_dual"], mu)
            else:
                y = magnitude_prox_cols_elem(ax, b, c["m_dual"], mu)
            j_m = _sub(ax, y)
            m_dual = Pair(c["m_dual"].re + mu * j_m.re,
                          c["m_dual"].im + mu * j_m.im)
        aty = ah_mul(y)

        # Z-update (ref :423-485)
        if has_z:
            with jax.named_scope("admm_zprox"):
                z_in = Pair(x.re + c["n_dual"].re * inv_mu,
                            x.im + c["n_dual"].im * inv_mu)
                z, v_basis = z_prox(z_in, mu, c["v_basis"])
        else:
            z, v_basis = z0, c["v_basis"]

        # N-dual update (ref :336-341)
        if has_z:
            j_n = _sub(x, z)
            n_dual = Pair(c["n_dual"].re + mu * j_n.re,
                          c["n_dual"].im + mu * j_n.im)
        else:
            j_n = _zeros((1, 1))
            n_dual = c["n_dual"]

        # best-so-far (ref :343-361)
        if scale_by_row:
            amp = jnp.sqrt(jnp.maximum(
                jnp.sum(ax.re ** 2 + ax.im ** 2, axis=-2), 0.0))
            obj = jnp.linalg.norm(amp - b)
            better = obj < c["opt_obj"]
            opt_x = Pair(jnp.where(better, x.re, c["opt_x"].re),
                         jnp.where(better, x.im, c["opt_x"].im))
            opt_y = Pair(jnp.where(better, y.re, c["opt_y"].re),
                         jnp.where(better, y.im, c["opt_y"].im))
            opt_obj = jnp.minimum(obj, c["opt_obj"])
        else:
            amp = jnp.sqrt(jnp.maximum(ax.re ** 2 + ax.im ** 2, 0.0))
            objs = jnp.linalg.norm(amp - b[None, :], axis=-1)    # (r,)
            j = jnp.argmin(objs)
            obj = objs[j]
            better = obj < c["opt_obj"]
            opt_x = Pair(jnp.where(better, x.re[j], c["opt_x"].re),
                         jnp.where(better, x.im[j], c["opt_x"].im))
            opt_y = Pair(jnp.where(better, y.re[j], c["opt_y"].re),
                         jnp.where(better, y.im[j], c["opt_y"].im))
            opt_obj = jnp.minimum(obj, c["opt_obj"])

        # convergence tests (ref :363-375)
        nax, ny = _norm(ax), _norm(y)
        naty = _norm(aty)
        if has_z:
            nx, nz = _norm(x), _norm(z)
            res_prim = jnp.sqrt(_fro2(j_m) + _fro2(j_n))
            res_dual = mu * jnp.sqrt(_fro2(_sub(aty, aty0))
                                     + _fro2(_sub(z, z0)))
            res_comb = jnp.sqrt(res_prim ** 2 + _fro2(_sub(y, y0))
                                + _fro2(_sub(z, z0)))
            t_prim = (tol_abs * math.sqrt((m + n) * r)
                      + tol_rel * jnp.sqrt(jnp.maximum(nax, ny) ** 2
                                           + jnp.maximum(nx, nz) ** 2))
            t_dual = (tol_abs * math.sqrt(n * r * 2)
                      + tol_rel * jnp.sqrt(naty ** 2 + nz ** 2))
            t_comb = (tol_abs * math.sqrt((m + n) * r * 2)
                      + tol_rel * jnp.sqrt(jnp.maximum(nax, ny) ** 2
                                           + jnp.maximum(nx, nz) ** 2
                                           + ny ** 2 + nz ** 2))
        else:
            res_prim = _norm(j_m)
            res_dual = mu * _norm(_sub(aty, aty0))
            res_comb = jnp.sqrt(res_prim ** 2 + _fro2(_sub(y, y0)))
            t_prim = tol_abs * math.sqrt(m * r) + tol_rel * jnp.maximum(nax, ny)
            t_dual = tol_abs * math.sqrt(n * r) + tol_rel * naty
            t_comb = (tol_abs * math.sqrt(m * r * 2)
                      + tol_rel * jnp.sqrt(jnp.maximum(nax, ny) ** 2 + ny ** 2))

        converged = jnp.logical_or(
            jnp.logical_and(res_prim < t_prim, res_dual < t_dual),
            res_comb < t_comb)
        mu = jnp.where(res_comb > c["last_res"] * 0.9, mu * rho, mu)

        return dict(y=y, z=z, m_dual=m_dual, n_dual=n_dual, aty=aty,
                    v_basis=v_basis, mu=mu, last_res=res_comb,
                    opt_obj=opt_obj, opt_x=opt_x, opt_y=opt_y,
                    it=c["it"] + 1, done=converged, converged=converged)

    if warm_iters > 0:
        # Mixed-precision schedule (see config.AdmmConfig.warm_iters): the
        # SAME body traced twice — first under the backend's "default"
        # matmul precision (a reduced-mantissa tensor-core product on
        # GPUs), bounded at warm_iters, then under the ambient (float32)
        # precision from the carried state.  The f32 tail pays only for
        # the last decades of contraction.
        warm_bound = min(warm_iters, maxiter)

        def cond_warm(c):
            return jnp.logical_and(c["it"] < warm_bound,
                                   jnp.logical_not(c["done"]))

        with jax.default_matmul_precision("default"):
            init = lax.while_loop(cond_warm, body, init)
        # coarse-precision residuals must not certify convergence, and the
        # coarse best-so-far objective (computed with noisy matmuls) must
        # not block the f32 tail's genuinely better states: reset both at
        # the phase switch (opt_x is immediately re-filled by the first
        # f32 iteration since any finite objective beats inf)
        init = dict(init, done=jnp.zeros_like(init["done"]),
                    converged=jnp.zeros_like(init["converged"]),
                    opt_obj=jnp.full_like(init["opt_obj"], jnp.inf))

    out = lax.while_loop(cond, body, init)
    return out["opt_x"], out["opt_y"], out["converged"], out["it"]


def _orthonormalize_cols_t(x: Pair) -> Pair:
    """X <- X * eigvec(X^H X) in transposed layout (ref :263-264)."""
    r = x.shape[-2]
    g = matmul(conj(x), _t(x))     # g_cd = sum_k conj(X_kc) X_kd = (X^H X)_cd
    g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
    _, v_emb = eigh_jacobi(embed_hermitian(g))
    # Build the complex eigvec matrix from every other embedded column:
    # [vr; vi] -> vr + i vi (the embedding duplicates each eigenvalue).
    vecs = v_emb[:, 0::2]
    v_c = Pair(vecs[:r, :], vecs[r:, :])                         # (r, r) cols
    # x_new^T = (X V)^T = V^T X^T  => pair matmul with V^T (no conjugate)
    return matmul(_t(v_c), x)


def _normalize_problem_pair(a: Pair, b, tol_abs: float):
    """Scale A to ||A||_F = sqrt(m_eff), B to unit norm (ref :27-38).

    ``m_eff`` counts ACTIVE rows (b > 0): static-shape padding rows
    (A_i = 0, b_i = 0, see :func:`.cplx.magnitude_prox_rows`) leave the
    normalization — and hence the effective ridge in U = inv(A^H A + I) —
    identical to the unpadded problem.
    """
    m_eff = jnp.maximum(jnp.sum(b > 0), 1).astype(jnp.float32)
    a_norm = _norm(a) / jnp.sqrt(m_eff)
    a_norm = jnp.where(a_norm < tol_abs, 1.0, a_norm)
    b_norm = jnp.linalg.norm(b)
    b_norm = jnp.where(b_norm < tol_abs, 1.0, b_norm)
    return _scale(a, 1.0 / a_norm), b / b_norm, a_norm, b_norm


def _split(key, m: int, frac: float, use_floor: bool = True):
    k = int(math.floor(m * frac)) if use_floor else int(math.ceil(m * frac))
    perm = jax.random.permutation(key, m)
    return perm[:k], perm[k:]


def _take_rows(a: Pair, idx) -> Pair:
    return Pair(a.re[idx], a.im[idx])


def _impl_pair(a: Pair, b, xs: Pair, nt, nr, use_rank_one: bool,
               cfg: AdmmConfig, prox_kind: str, eig_mode: str,
               ladder=None, u_mat: Optional[Pair] = None):
    """inferLowRankImpl in pair layout (ref :111-271).

    ``ladder``/``u_mat`` may be supplied by the caller: the staged batch
    solver passes a traced :class:`.cplx.LadderArrays` (so retry/normal
    solves share one compiled graph) and hoists the per-train-split
    U = inv(A^H A + I) precompute out of the instance vmap.
    """
    m, n = a.shape
    if prox_kind == "nuclear":
        ladder = None
    elif ladder is None:
        ladder = profile_ladder(nt, nr, m, n, use_rank_one,
                                cfg.profile.rank_mults, cfg.profile.fractions,
                                mode=cfg.profile.ladder)
    if u_mat is None:
        u_mat = precompute_u_pair(a)
    kw = dict(nt=nt, nr=nr, ladder=ladder, u_mat=u_mat, prox_kind=prox_kind,
              mu0=cfg.mu0, rho=cfg.rho, tol_rel=cfg.tol_rel,
              tol_abs=cfg.tol_abs, maxiter=cfg.maxiter, eig_mode=eig_mode,
              warm_iters=cfg.warm_iters)
    # pass-1 cap (cfg.stage1_maxiter): pass 2 re-converges from the
    # orthonormalized state, so pass-1 tail iterations are mostly re-done
    # work — see the config docstring
    kw1 = dict(kw, maxiter=min(cfg.stage1_maxiter, cfg.maxiter)) \
        if cfg.stage1_maxiter is not None else kw
    # pass-2 cap (cfg.stage2_maxiter): bounds the vmapped-lockstep
    # straggler; the full-data refinement stage re-converges the selected
    # restart at full maxiter
    kw2 = dict(kw, maxiter=min(cfg.stage2_maxiter, cfg.maxiter)) \
        if cfg.stage2_maxiter is not None else kw
    x, y, _, it1 = infer_admm_pair(a, b, xs, scale_by_row=True, **kw1)
    x = _orthonormalize_cols_t(x)
    x, y, converged, it2 = infer_admm_pair(a, b, x, scale_by_row=False, **kw2)
    # per-solve trip counts, stacked: callers that only need the total sum
    # the last axis; the batch solver's waste accounting needs them split
    # (a vmapped while_loop runs every lane to the slowest lane's count)
    return x, y, converged, jnp.stack([it1, it2])


def _refine_cond_pair(a, b, x0, nt, nr, rank_one_flag, cfg, prox_kind,
                      eig_mode, ladder_m=None):
    """Full-data refinement with traced use_rank_one flag (ref :92,:100).

    ``ladder_m`` overrides the row count used for constraint-ladder
    selection (active rows of a padded problem; see solve_lowrank_multi_pair).
    """
    m, n = a.shape
    lm = m if ladder_m is None else ladder_m

    def run(use_r1):
        ladder = (None if prox_kind == "nuclear" else
                  profile_ladder(nt, nr, lm, n, use_r1,
                                 cfg.profile.rank_mults,
                                 cfg.profile.fractions,
                                 mode=cfg.profile.ladder))
        x, y, _, it = infer_admm_pair(
            a, b, x0, scale_by_row=True, nt=nt, nr=nr, ladder=ladder,
            prox_kind=prox_kind, mu0=cfg.mu0, rho=cfg.rho,
            tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs, maxiter=cfg.maxiter,
            eig_mode=eig_mode)
        return x, y, it

    return lax.cond(rank_one_flag, lambda: run(True), lambda: run(False))


@partial(jax.jit, static_argnames=("nt", "nr", "cfg", "prox_kind",
                                   "eig_mode"))
def _batch_first_pass(k_inits, a: Pair, b_batch, trains, tests,
                      ladder: LadderArrays, nt: int, nr: int,
                      cfg: AdmmConfig, prox_kind: str, eig_mode: str,
                      m_eff=None):
    """Stage 1 of the batched solver: normalize + every (instance, restart)
    first-pass solve (ref: inferLowRankV4_multi.m:27-68).

    Returns ``(x (B,R,n), q (B,R), it (B,R,2), xs (B,R,r,n), a_n, b_n,
    a_norm, b_norm)`` — ``it[..., 0]``/``it[..., 1]`` are the per-lane trip
    counts of the scale_by_row / per-column solves (split for lockstep-waste
    accounting; see scripts/bench_lockstep.py).  U = inv(A^H A + I) of each train split is hoisted
    out of the instance vmap (the codebook is shared, so it depends only
    on the restart's split).  ``m_eff`` is the ACTIVE row count (= m
    unless the batch carries b == 0 padding rows), matching the single
    solver's _normalize_problem_pair.
    """
    m, n = a.shape
    r = min(cfg.rank, trains.shape[1], n)
    m_eff = jnp.asarray(m if m_eff is None else m_eff, jnp.float32)
    a_norm = _norm(a) / jnp.sqrt(m_eff)
    a_norm = jnp.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    a_n = _scale(a, 1.0 / a_norm)
    b_norm = jnp.linalg.norm(b_batch, axis=-1)
    b_norm = jnp.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    b_n = b_batch / b_norm[:, None]

    def per_restart(k_inits_r, train, test):
        a_tr, a_te = _take_rows(a_n, train), _take_rows(a_n, test)
        u_tr = precompute_u_pair(a_tr)

        def per_instance(k_init, b):
            b_tr, b_te = b[train], b[test]
            xs = spectral_initialize_pair(a_tr, b_tr, r, key=k_init)
            x, _, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, False, cfg,
                                     prox_kind, eig_mode,
                                     ladder=ladder, u_mat=u_tr)
            return x, _quality_pair(a_te, b_te, x), it, xs

        return jax.vmap(per_instance)(k_inits_r, b_n)

    x, q, it, xs = jax.vmap(per_restart, in_axes=(1, 0, 0), out_axes=1)(
        k_inits, trains, tests)
    return x, q, it, xs, a_n, b_n, a_norm, b_norm


@partial(jax.jit, static_argnames=("nt", "nr", "cfg", "prox_kind",
                                   "eig_mode"))
def _batch_retry(a_n: Pair, b_sel, train_sel, test_sel, xs_sel: Pair,
                 rest_sel, trains, ladder: LadderArrays, nt: int, nr: int,
                 cfg: AdmmConfig, prox_kind: str, eig_mode: str):
    """Stage 2: rank-1 retry of the gathered poor (instance, restart)
    pairs only (ref: inferLowRankV4_multi.m:73-77).  ``b_sel`` (K, m),
    ``train_sel``/``test_sel`` (K, k)/(K, m-k), ``xs_sel`` (K, r, n),
    ``rest_sel`` (K,) restart index of each pair, ``trains`` (R, k).

    U = inv(A^H A + I) depends only on the restart's train split, so the
    R distinct U matrices are computed once and indexed per pair instead
    of re-running the Cholesky inversion K times inside the vmap."""
    u_all = jax.vmap(lambda tr: precompute_u_pair(_take_rows(a_n, tr)))(
        trains)                                               # (R, n, n)

    def one(b, train, test, xs, rest):
        a_tr, a_te = _take_rows(a_n, train), _take_rows(a_n, test)
        b_tr, b_te = b[train], b[test]
        u_tr = Pair(u_all.re[rest], u_all.im[rest])
        x, _, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, True, cfg,
                                 prox_kind, eig_mode,
                                 ladder=ladder, u_mat=u_tr)
        return x, _quality_pair(a_te, b_te, x), jnp.sum(it)

    return jax.vmap(one)(b_sel, train_sel, test_sel, xs_sel, rest_sel)


@partial(jax.jit, static_argnames=("nt", "nr", "cfg", "prox_kind",
                                   "eig_mode"))
def _batch_refine(a_n: Pair, b_n, x: Pair, q, it_sum, rank_one_flags,
                  ladder_normal: LadderArrays, ladder_r1: LadderArrays,
                  a_norm, b_norm, nt: int, nr: int, cfg: AdmmConfig,
                  prox_kind: str, eig_mode: str) -> PairAdmmResult:
    """Stage 3: best-restart selection, full-data refinement with
    similarity rollback, rescale (ref: inferLowRankV4_multi.m:79-107).

    The reference re-solves with the rank-1 constraint when the selected
    restart used the fallback (ref :92,:100); here that flag selects
    between two ladder *arrays* feeding ONE solver graph — under the
    instance vmap a ``lax.cond`` of two solves would execute both.
    """
    thr = cfg.quality_threshold
    u_full = precompute_u_pair(a_n)

    def one(x_i, q_i, r1_i, b, it_i, b_norm_i):
        j = jnp.argmax(q_i)                           # first max on ties
        x_max = Pair(x_i.re[j][None, :], x_i.im[j][None, :])
        q_max = q_i[j]
        rank_one = r1_i[j]
        lad = None
        if prox_kind != "nuclear":
            lad = LadderArrays(
                jnp.where(rank_one, ladder_r1.ranks, ladder_normal.ranks),
                jnp.where(rank_one, ladder_r1.fracs, ladder_normal.fracs))
        x_ref, _, _, it_ref = infer_admm_pair(
            a_n, b, x_max, scale_by_row=True, nt=nt, nr=nr, ladder=lad,
            u_mat=u_full, prox_kind=prox_kind, mu0=cfg.mu0, rho=cfg.rho,
            tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs, maxiter=cfg.maxiter,
            eig_mode=eig_mode)
        # similarity |<x_max, x_ref>| / (||x_max|| ||x_ref||)  (ref :93-98)
        dot_re = jnp.sum(x_max.re * x_ref.re + x_max.im * x_ref.im)
        dot_im = jnp.sum(x_max.re * x_ref.im - x_max.im * x_ref.re)
        similarity = (jnp.sqrt(dot_re ** 2 + dot_im ** 2)
                      / jnp.maximum(_norm(x_max) * _norm(x_ref), 1e-30))
        rollback = jnp.logical_and(q_max > thr,
                                   similarity < cfg.similarity_threshold)
        xo = Pair(jnp.where(rollback, x_max.re, x_ref.re),
                  jnp.where(rollback, x_max.im, x_ref.im))
        s = b_norm_i / a_norm
        return PairAdmmResult(
            x=Pair(xo.re[0] * s, xo.im[0] * s), quality=q_max,
            converged=jnp.asarray(True), iters=it_i + it_ref)

    return jax.vmap(one)(x, q, rank_one_flags, b_n, it_sum, b_norm)


def solve_lowrank_multi_pair_batch(key, a: Pair, b_batch, nt: int, nr: int,
                                   cfg: AdmmConfig = AdmmConfig(),
                                   prox_kind: str = "spectral_profile",
                                   eig_mode: str = "perturb",
                                   n_restarts: Optional[int] = None
                                   ) -> PairAdmmResult:
    """Batch of recoveries through ONE shared probing codebook.

    The testbed's production setting: every repeat / M-subset / restart
    measures through the same flashed .brd codebook (ref: main/main.py:426-440),
    so ``a`` is (m, n) unbatched while ``b_batch`` is (batch, m).  The
    train/test split is drawn once per restart and shared across the batch,
    which keeps the codebook un-batched inside the vmap — XLA then folds
    (batch, r) into one tall matmul row dimension instead of running a
    batch of thin per-instance products.

    NOT itself jittable: this is a host-staged pipeline of three jitted
    stages with ONE tiny host readback (the (B, R) quality gate) between
    them.  The reference only pays the rank-1 retry when a restart's
    held-out quality is poor (ref: inferLowRankV4_multi.m:73-77); a
    single-jit formulation vmapped over instances turns that data-dependent
    branch into a select that runs the retry for EVERY instance.  Staging
    gathers just the poor (instance, restart) pairs (bucket-padded to limit
    recompiles) and scatters the results back — typically zero extra work.

    Per-instance PRNG streams still drive the spectral initialization.
    Returns a PairAdmmResult with a leading batch axis.
    """
    import numpy as np

    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    batch = b_batch.shape[0]
    m, n = a.shape
    pl = cfg.profile

    # active-row accounting (b == 0 rows are inactive padding by contract,
    # see solve_lowrank_multi_pair): normalization and ladder selection
    # must follow the ACTIVE count like the single solver's
    # _normalize_problem_pair.  A is shared across the batch, so its
    # normalization admits only one count — require it to be uniform.
    if isinstance(b_batch, np.ndarray):
        counts = np.sum(b_batch > 0, axis=1)        # pure host, no sync
    else:
        # reduce on device first: syncs a (B,) int vector, not (B, m) floats
        counts = np.asarray(jnp.sum(b_batch > 0, axis=1))
    m_act = int(counts[0]) if batch else m
    if batch and not (counts == m_act).all():
        raise ValueError(
            "solve_lowrank_multi_pair_batch shares one codebook across the "
            "batch, so every instance must have the same active (b > 0) row "
            f"count; got {sorted(set(counts.tolist()))}.  b == 0 marks an "
            "INACTIVE padding row by contract (real measured amplitudes "
            "are strictly positive, A2only.m:130-139) — if these zeros are "
            "genuine measurements, clamp them to a tiny positive floor; "
            "otherwise pad uniformly or use solve_lowrank_multi_pair per "
            "instance.")
    m_act = max(m_act, 1)

    # same key derivation as _solve_lowrank_core (instance streams + shared
    # per-restart splits)
    keys = jax.random.split(jax.random.fold_in(key, 7), batch)
    k_inits = jax.vmap(lambda ki: jnp.stack(
        [jax.random.split(jax.random.fold_in(ki, i))[1]
         for i in range(n_restarts)]))(keys)                     # (B, R, 2)
    splits = tuple(
        _split(jax.random.split(jax.random.fold_in(key, i))[0], m,
               cfg.cc_frac)
        for i in range(n_restarts))
    trains = jnp.stack([t for t, _ in splits])
    tests = jnp.stack([t for _, t in splits])
    # ladder selection by ACTIVE counts (identical to padded when no padding)
    lm_tr = int(math.floor(m_act * cfg.cc_frac))

    lad_tr = profile_ladder_arrays(nt, nr, lm_tr, n, False, pl.rank_mults,
                                   pl.fractions, mode=pl.ladder)
    # trace-time matmul precision for all three staged jits (see
    # config.AdmmConfig.matmul_precision; participates in the jit key)
    with jax.default_matmul_precision(cfg.matmul_precision):
        x, q, it, xs, a_n, b_n, a_norm, b_norm = _batch_first_pass(
            k_inits, a, b_batch, trains, tests, lad_tr, nt=nt, nr=nr,
            cfg=cfg, prox_kind=prox_kind, eig_mode=eig_mode, m_eff=m_act)
    it = jnp.sum(it, axis=-1)                   # (B, R) per-lane totals

    rank_one = np.zeros((batch, n_restarts), bool)
    if prox_kind != "nuclear":
        poor = np.asarray(q) < cfg.quality_threshold      # host readback
        if poor.any():
            inst_idx, rest_idx = np.nonzero(poor)
            k_n = inst_idx.shape[0]
            # bucket-pad to the next power of two to bound recompiles
            # (pad entries repeat pair 0; their results are discarded)
            k_pad = 1 << max(0, (k_n - 1).bit_length())
            inst_p = np.concatenate(
                [inst_idx, np.full(k_pad - k_n, inst_idx[0], np.int64)])
            rest_p = np.concatenate(
                [rest_idx, np.full(k_pad - k_n, rest_idx[0], np.int64)])
            lad_r1 = profile_ladder_arrays(nt, nr, lm_tr, n, True,
                                           pl.rank_mults, pl.fractions,
                                           mode=pl.ladder)
            with jax.default_matmul_precision(cfg.matmul_precision):
                xr, qr, itr = _batch_retry(
                    a_n, b_n[inst_p], trains[rest_p], tests[rest_p],
                    Pair(xs.re[inst_p, rest_p], xs.im[inst_p, rest_p]),
                    jnp.asarray(rest_p), trains,
                    lad_r1, nt=nt, nr=nr, cfg=cfg, prox_kind=prox_kind,
                    eig_mode=eig_mode)
            ii, rr = inst_idx, rest_idx
            x = Pair(x.re.at[ii, rr].set(xr.re[:k_n]),
                     x.im.at[ii, rr].set(xr.im[:k_n]))
            q = q.at[ii, rr].set(qr[:k_n])
            it = it.at[ii, rr].add(itr[:k_n])
            rank_one[ii, rr] = True

    lad_full = profile_ladder_arrays(nt, nr, m_act, n, False, pl.rank_mults,
                                     pl.fractions, mode=pl.ladder)
    lad_full_r1 = profile_ladder_arrays(nt, nr, m_act, n, True,
                                        pl.rank_mults, pl.fractions,
                                        mode=pl.ladder)
    with jax.default_matmul_precision(cfg.matmul_precision):
        return _batch_refine(a_n, b_n, x, q, jnp.sum(it, axis=1),
                             jnp.asarray(rank_one), lad_full, lad_full_r1,
                             a_norm, b_norm, nt=nt, nr=nr, cfg=cfg,
                             prox_kind=prox_kind, eig_mode=eig_mode)


@partial(jax.jit, static_argnames=("nt", "nr", "cfg", "prox_kind",
                                   "eig_mode", "n_restarts", "ladder_m"))
def solve_lowrank_multi_pair(key, a: Pair, b, nt: int, nr: int,
                             cfg: AdmmConfig = AdmmConfig(),
                             prox_kind: str = "spectral_profile",
                             eig_mode: str = "perturb",
                             n_restarts: Optional[int] = None,
                             ladder_m: Optional[int] = None
                             ) -> PairAdmmResult:
    """The 2ACE "A2" solver, fully in pair representation (the single-
    recovery / tracking path).

    Semantics mirror :func:`.admm.solve_lowrank_multi`
    (ref: inferLowRankV4_multi.m:5-109): normalize, 3 restarts of
    {train/test split, spectral init, over-parameterized ADMM +
    orthonormalize + per-column refinement, quality check, rank-1 retry},
    keep the best, full-data refinement with similarity rollback, rescale.

    Rows with ``b == 0`` are treated as inactive padding BY CONTRACT (their
    A rows must be zero too): real measured amplitudes are strictly
    positive (the reference's rss -> amplitude chain
    ``sqrt(db2pow(rss)/1000) * rss_fct`` cannot produce 0, A2only.m:130-139).
    ``ladder_m`` gives the ACTIVE row count of such a padded problem so the
    constraint-ladder selection (the ``m >= 3n`` overdetermined test,
    inferLowRankV4_multi.m:447) follows the active — not padded — shape;
    callers should snap it to the branch boundary to avoid one compile per
    distinct count (see pipeline.mobility._ladder_m_for_window).
    """
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    # cfg.matmul_precision applies at trace time (see config.AdmmConfig)
    with jax.default_matmul_precision(cfg.matmul_precision):
        return _solve_lowrank_core(key, a, b, nt, nr, cfg, prox_kind,
                                   eig_mode, n_restarts, None,
                                   ladder_m=ladder_m)


def _solve_lowrank_core(key, a: Pair, b, nt: int, nr: int, cfg: AdmmConfig,
                        prox_kind: str, eig_mode: str, n_restarts: int,
                        splits,
                        ladder_m: Optional[int] = None) -> PairAdmmResult:
    """Shared scaffold; ``splits`` optionally provides per-restart
    (train, test) index vectors (used by the shared-codebook batch path)."""
    m, n = a.shape
    r = min(cfg.rank, m, n)
    a, b, a_norm, b_norm = _normalize_problem_pair(a, b, cfg.tol_abs)
    thr = cfg.quality_threshold

    # constraint ladders from the ACTIVE row count (= m unless the caller
    # padded the problem and passed ladder_m); the train-split ladder uses
    # the active train count, floor(cc_frac * active) matching _split
    lm_full = m if ladder_m is None else ladder_m
    lm_tr = int(math.floor(lm_full * cfg.cc_frac))
    pl = cfg.profile
    if prox_kind == "nuclear":
        lad_tr = lad_tr_r1 = None
    else:
        lad_tr = profile_ladder(nt, nr, lm_tr, n, False, pl.rank_mults,
                                pl.fractions, mode=pl.ladder)
        lad_tr_r1 = profile_ladder(nt, nr, lm_tr, n, True, pl.rank_mults,
                                   pl.fractions, mode=pl.ladder)

    # --- restarts, VMAPPED (the reference runs them serially,
    # inferLowRankV4_multi.m:42-84; they are independent until the best-of
    # selection, so they ride a free batch axis — SURVEY §2.8) ---
    keys_r = [jax.random.fold_in(key, i) for i in range(n_restarts)]
    k_inits = jnp.stack([jax.random.split(k)[1] for k in keys_r])
    if splits is None:
        tr_te = [_split(jax.random.split(k)[0], m, cfg.cc_frac)
                 for k in keys_r]
    else:
        tr_te = splits
    trains = jnp.stack([t for t, _ in tr_te])
    tests = jnp.stack([t for _, t in tr_te])

    def first_pass(k_init, train, test):
        a_tr, b_tr = _take_rows(a, train), b[train]
        a_te, b_te = _take_rows(a, test), b[test]
        xs = spectral_initialize_pair(a_tr, b_tr, r, key=k_init)
        x, y, _, it = _impl_pair(a_tr, b_tr, xs, nt, nr, False, cfg,
                                 prox_kind, eig_mode, ladder=lad_tr)
        return x, y, _quality_pair(a_te, b_te, x), it, xs

    x, y, q, it, xs = jax.vmap(first_pass)(k_inits, trains, tests)

    if prox_kind != "nuclear":
        poor = q < thr                                # (R,)

        def retry_all():
            def one(train, test, xs_i):
                a_tr, b_tr = _take_rows(a, train), b[train]
                a_te, b_te = _take_rows(a, test), b[test]
                xr, yr, _, itr = _impl_pair(a_tr, b_tr, xs_i, nt, nr, True,
                                            cfg, prox_kind, eig_mode,
                                            ladder=lad_tr_r1)
                return xr, yr, _quality_pair(a_te, b_te, xr), itr

            xr, yr, qr, itr = jax.vmap(one)(trains, tests, xs)
            sel = poor[:, None]
            x2 = Pair(jnp.where(sel, xr.re, x.re),
                      jnp.where(sel, xr.im, x.im))
            y2 = Pair(jnp.where(sel, yr.re, y.re),
                      jnp.where(sel, yr.im, y.im))
            return (x2, y2, jnp.where(poor, qr, q),
                    it + jnp.where(poor[:, None], itr, 0))

        # Scalar any(poor) predicate: the rank-1 retry stays a LAZY branch
        # in the single-recovery jit (it only runs when some restart fails
        # the quality gate, matching the reference's data-dependent retry,
        # ref :73-77).  Under the batch solver's instance-vmap the cond
        # lowers to a select, same cost as the old per-restart conds.
        x, y, q, it = lax.cond(jnp.any(poor), retry_all,
                               lambda: (x, y, q, it))
        rank_one = poor
    else:
        rank_one = jnp.zeros((n_restarts,), bool)
    iters_total = jnp.sum(it).astype(jnp.int32)

    j = jnp.argmax(q)                                 # first max on ties
    x_max = Pair(x.re[j], x.im[j])                    # (n,)
    q_max = q[j]
    rank_one = rank_one[j]
    x_max = Pair(x_max.re[None, :], x_max.im[None, :])            # (1, n)

    x_ref, y_ref, it_ref = _refine_cond_pair(a, b, x_max, nt, nr, rank_one,
                                             cfg, prox_kind, eig_mode,
                                             ladder_m=ladder_m)
    iters_total = iters_total + it_ref
    # similarity |<x_max, x_ref>| / (||x_max|| ||x_ref||)  (ref :93-98)
    dot_re = jnp.sum(x_max.re * x_ref.re + x_max.im * x_ref.im)
    dot_im = jnp.sum(x_max.re * x_ref.im - x_max.im * x_ref.re)
    similarity = (jnp.sqrt(dot_re ** 2 + dot_im ** 2)
                  / jnp.maximum(_norm(x_max) * _norm(x_ref), 1e-30))
    rollback = jnp.logical_and(q_max > thr,
                               similarity < cfg.similarity_threshold)
    x = Pair(jnp.where(rollback, x_max.re, x_ref.re),
             jnp.where(rollback, x_max.im, x_ref.im))

    scale = b_norm / a_norm
    return PairAdmmResult(x=Pair(x.re[0] * scale, x.im[0] * scale),
                          quality=q_max, converged=jnp.asarray(True),
                          iters=iters_total)


@partial(jax.jit, static_argnames=("nt", "nr", "cfg", "prox_kind",
                                   "ladder_m", "use_rank_one",
                                   "anchor_weight"))
def refine_lowrank_pair(a: Pair, b, x0: Pair, nt: int, nr: int,
                        cfg: AdmmConfig = AdmmConfig(),
                        prox_kind: str = "spectral_profile",
                        ladder_m: Optional[int] = None,
                        use_rank_one: bool = False,
                        anchor_weight: float = 0.0) -> PairAdmmResult:
    """Warm-started single refinement solve: the reference's full-data
    refinement step (ref: inferLowRankV4_multi.m:89-101) as a standalone
    entry, seeded by ``x0`` (n,) instead of spectral initialization.

    The mobility tracker uses this to warm-start window t from window
    t-1's estimate (the reference re-solves cold per window,
    RSS_Mobility.m:155-188; warm-starting accumulates cross-window beam
    diversity and typically converges in a fraction of the iterations).
    ``quality`` in the result is the FULL-data fit 1 - ||(|A x|) - b||/||b||
    over active (b > 0) rows — callers gate on it and fall back to the
    full scaffold when the warm path decays.

    ``anchor_weight > 0`` adds the proximal tracking term
    ``anchor_weight * ||x - x0||^2`` to the X-subproblem: directions the
    current window's rows do not measure stay at the previous estimate
    instead of being re-randomized, which is what lets a sliding-window
    tracker accumulate beam diversity across windows (the testbed's kron
    probing shows each window only ~2 Rx sectors).
    """
    m, n = a.shape
    a_n, b_n, a_norm, b_norm = _normalize_problem_pair(a, b, cfg.tol_abs)
    lm = m if ladder_m is None else ladder_m
    x0n = Pair((x0.re * (a_norm / b_norm))[None, :],
               (x0.im * (a_norm / b_norm))[None, :])
    ladder = (None if prox_kind == "nuclear" else
              profile_ladder(nt, nr, lm, n, use_rank_one,
                             cfg.profile.rank_mults, cfg.profile.fractions,
                             mode=cfg.profile.ladder))
    with jax.default_matmul_precision(cfg.matmul_precision):
        x, _, converged, it = infer_admm_pair(
            a_n, b_n, x0n, scale_by_row=True, nt=nt, nr=nr, ladder=ladder,
            prox_kind=prox_kind, mu0=cfg.mu0, rho=cfg.rho,
            tol_rel=cfg.tol_rel, tol_abs=cfg.tol_abs, maxiter=cfg.maxiter,
            eig_mode="perturb",
            warm_iters=cfg.warm_iters,
            anchor=x0n if anchor_weight > 0.0 else None,
            anchor_weight=anchor_weight)
        q = _quality_pair(a_n, b_n, x)
    s = b_norm / a_norm
    return PairAdmmResult(x=Pair(x.re[0] * s, x.im[0] * s), quality=q,
                          converged=converged, iters=it)
