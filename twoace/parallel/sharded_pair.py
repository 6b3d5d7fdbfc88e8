"""Row-sharded + batch-sharded 2ACE ADMM in pair representation.

The pair twin of :mod:`.sharded_admm`: same (batch x rows) mesh and the
same one-``psum``-per-iteration communication pattern (SURVEY §2.8), but
complex matrices are carried as (re, im) float32 pairs in the transposed
r-leading layout of :mod:`..ops.pair_solver`, so a multi-device solve
runs the same representation as the single-device production solvers.

Collectives (all over the ``rows`` axis):
  - normalization + spectral-init Gram: one psum each (setup)
  - per ADMM iteration: one psum for the ``A^H (...)`` reduction and one
    fused psum for the scalar residual norms
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import AdmmConfig
from ..ops.cplx import (
    LadderArrays,
    Pair,
    add,
    embed_hermitian,
    ladder_scales,
    eigh_update_perturbative_pair,
    magnitude_prox_cols,
    matmul,
    panel_gram_basis_pair,
    unembed,
)
from ..ops.eigh_jacobi import eigh_jacobi
from ..ops.pair_solver import (
    _panel_maps,
    magnitude_prox_cols_elem,
    project_cols_to_magnitude,
)
from ..ops.prox import profile_ladder, profile_ladder_arrays
from .mesh import BATCH_AXIS, ROWS_AXIS


def _t(p: Pair) -> Pair:
    return Pair(jnp.swapaxes(p.re, -1, -2), jnp.swapaxes(p.im, -1, -2))


def _psum_helpers(axis):
    if axis is None:
        def psum(v):
            return v
    else:
        def psum(v):
            return lax.psum(v, axis)

    def psum_p(p: Pair) -> Pair:
        return Pair(psum(p.re), psum(p.im))

    def gnorm2(p: Pair):
        return psum(jnp.sum(p.re * p.re + p.im * p.im))

    return psum, psum_p, gnorm2


def _precompute_u_sharded(a_loc: Pair, psum_p):
    """U = inv(A^H A + I): local partial Gram, psum, replicated Cholesky."""
    n = a_loc.shape[-1]
    gram = psum_p(matmul(_t(Pair(a_loc.re, -a_loc.im)), a_loc))
    gram = Pair(0.5 * (gram.re + gram.re.T)
                + jnp.eye(n, dtype=jnp.float32),
                0.5 * (gram.im - gram.im.T))
    g_emb = embed_hermitian(gram)
    chol = jnp.linalg.cholesky(g_emb)
    eye2n = jnp.eye(2 * n, dtype=jnp.float32)
    wtri = jax.scipy.linalg.solve_triangular(chol, eye2n, lower=True)
    u_mat = unembed(wtri.T @ wtri, n)
    return Pair(u_mat.re, -u_mat.im)                      # U^T (u_conj)


def _spectral_init_sharded(a_loc: Pair, b_loc, r: int, psum_p,
                           oi_iters: int = 12, key=None):
    """Spectral init (ref :561-574): scaled Gram psum'd, then a replicated
    TOP-r orthogonal iteration (Cholesky-QR) on the (2n, 2n) real
    embedding — NOT a full eigh: a dense 2n x 2n Jacobi at 32x32
    (2048 x 2048) is both a pathological XLA:CPU compile and wasted work
    for r = 20 Ritz vectors.  Same scheme (and the same measured 12-step
    depth) as the unsharded spectral_initialize_pair.  ``key`` seeds the
    iteration start: callers pass a REPLICATED key (identical on every
    shard) so replicated state stays identical, while per-restart keys
    keep the CV restarts' initializations distinct like the single-chip
    scaffold's.

    Rows with zero norm (masked-out / padding rows) contribute nothing to
    the Gram, so a masked train split yields exactly the gathered-rows
    initialization."""
    from ..ops.pair_solver import _cholqr

    n = a_loc.shape[-1]
    r = min(r, n)
    row_norm = jnp.sqrt(jnp.maximum(
        jnp.sum(a_loc.re ** 2 + a_loc.im ** 2, axis=-1), 1e-30))
    scal = jnp.where(row_norm > 1e-15, b_loc / row_norm, 1.0)
    a_s = Pair(a_loc.re * scal[:, None], a_loc.im * scal[:, None])
    g_s = psum_p(matmul(_t(Pair(a_s.re, -a_s.im)), a_s))
    g_s = Pair(0.5 * (g_s.re + g_s.re.T), 0.5 * (g_s.im - g_s.im.T))
    g_emb = embed_hermitian(g_s)                              # (2n, 2n)
    if key is None:
        key = jax.random.PRNGKey(29)
    q = jax.random.normal(key, (2 * n, 2 * r), jnp.float32)

    def body(qc, _):
        return _cholqr(g_emb @ qc), None

    q, _ = lax.scan(body, _cholqr(q), None, length=oi_iters)
    rr_mat = q.T @ (g_emb @ q)
    w_s, s_r = eigh_jacobi(0.5 * (rr_mat + rr_mat.T))         # (2r, 2r)
    ritz = q @ s_r
    w_r = jnp.sqrt(jnp.maximum(w_s[0::2][:r], 0.0))
    vecs = ritz[:, 0::2][:, :r]
    return _t(Pair(vecs[:n] * w_r[None, :], vecs[n:] * w_r[None, :]))


def _make_admm(a_loc: Pair, b_loc, u_conj: Pair, ladder, cfg: AdmmConfig,
               psum, psum_p, gnorm2, m_eff: int, nt: int, nr: int,
               prox_kind: str, warm_iters: int = 0):
    """Build the row-sharded InferADMM closure over (possibly masked) local
    rows.  ``ladder`` may be a static tuple or traced :class:`LadderArrays`
    (the latter lets the rank-1 retry/refinement flag select ladder DATA
    instead of tracing a second solver); ``m_eff`` is the ACTIVE global row
    count feeding the residual thresholds (ref :363-375).  ``warm_iters``
    applies the mixed-precision schedule of
    :func:`..ops.pair_solver.infer_admm_pair` — a bounded default-precision
    warm loop before the ambient-precision tail (same reset of the
    convergence flag and best-so-far objective at the phase switch)."""
    m_loc, n = a_loc.shape
    a_conj = Pair(a_loc.re, -a_loc.im)                    # (m_loc, n)
    a_t = _t(a_loc)                                       # (n, m_loc)

    def _spectral_prox(z: Pair, v0):
        """Replicated spectral-profile prox with warm perturbative basis."""
        rr = z.shape[-2]
        to_panel, from_panel = _panel_maps(nt, nr, rr)
        e = Pair(to_panel(z.re), to_panel(z.im))
        if v0 is None:
            w, v = panel_gram_basis_pair(e)
        else:
            g = matmul(e, Pair(jnp.swapaxes(e.re, -1, -2),
                               -jnp.swapaxes(e.im, -1, -2)))
            g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
            w, v = eigh_update_perturbative_pair(g, v0)
        scale = ladder_scales(jnp.maximum(w, 0.0), ladder)
        coeff = jnp.sqrt(scale) - 1.0
        vc = Pair(v.re * coeff[None, :], v.im * coeff[None, :])
        delta = matmul(vc, Pair(v.re.T, -v.im.T))
        e_new = add(e, matmul(delta, e))
        return Pair(from_panel(e_new.re), from_panel(e_new.im)), v

    if prox_kind == "nuclear":
        from ..ops.pair_solver import _nuclear_prox_t

        def z_prox(z: Pair, mu, v0):
            del v0
            return _nuclear_prox_t(z, 1.0 / mu), jnp.eye(2 * nr,
                                                         dtype=jnp.float32)
    else:
        def z_prox(z: Pair, mu, v0):
            del mu
            return _spectral_prox(z, v0)

    m_global = m_eff

    def admm(x0: Pair, scale_by_row: bool):
        """Row-sharded InferADMM in transposed pair layout (ref :281-386)."""
        rr = x0.shape[-2]
        ax = matmul(x0, a_t)                              # (rr, m_loc)
        if scale_by_row:
            s = jnp.sqrt(psum(jnp.sum(b_loc ** 2))
                         / jnp.maximum(gnorm2(ax), 1e-30))
            x = Pair(x0.re * s, x0.im * s)
        else:
            col = jnp.sqrt(psum(jnp.sum(ax.re ** 2 + ax.im ** 2, axis=-1)))
            s = jnp.sqrt(psum(jnp.sum(b_loc ** 2))) / jnp.maximum(col, 1e-30)
            x = Pair(x0.re * s[:, None], x0.im * s[:, None])
        ax = matmul(x, a_t)
        y = project_cols_to_magnitude(ax, b_loc, scale_by_row)
        aty = psum_p(matmul(y, a_conj))
        z, v_basis = z_prox(x, jnp.asarray(cfg.mu0, jnp.float32), None)
        zeros_m = Pair(jnp.zeros((rr, m_loc), jnp.float32),
                       jnp.zeros((rr, m_loc), jnp.float32))
        zeros_n = Pair(jnp.zeros((rr, n), jnp.float32),
                       jnp.zeros((rr, n), jnp.float32))
        if scale_by_row:
            opt_x = zeros_n
            opt_y = zeros_m
        else:
            opt_x = Pair(jnp.zeros((n,), jnp.float32),
                         jnp.zeros((n,), jnp.float32))
            opt_y = Pair(jnp.zeros((m_loc,), jnp.float32),
                         jnp.zeros((m_loc,), jnp.float32))

        init = dict(y=y, z=z, m_dual=zeros_m, n_dual=zeros_n, aty=aty,
                    v_basis=v_basis, mu=jnp.asarray(cfg.mu0, jnp.float32),
                    last_res=jnp.asarray(jnp.inf, jnp.float32),
                    opt_obj=jnp.asarray(jnp.inf, jnp.float32),
                    opt_x=opt_x, opt_y=opt_y,
                    it=jnp.asarray(0, jnp.int32), done=jnp.asarray(False))

        def cond(c):
            return jnp.logical_and(c["it"] < cfg.maxiter,
                                   jnp.logical_not(c["done"]))

        def body(c):
            y0, z0, aty0 = c["y"], c["z"], c["aty"]
            mu = c["mu"]
            inv_mu = 1.0 / mu
            # X-update: local partial A^H(...) + psum (the rows collective)
            t = Pair(y0.re - c["m_dual"].re * inv_mu,
                     y0.im - c["m_dual"].im * inv_mu)
            rhs = add(psum_p(matmul(t, a_conj)),
                      Pair(z0.re - c["n_dual"].re * inv_mu,
                           z0.im - c["n_dual"].im * inv_mu))
            x = matmul(rhs, u_conj)                       # replicated
            ax = matmul(x, a_t)                           # row-local
            if scale_by_row:
                # per-measurement row norm reduces over the REPLICATED r
                # axis -> no collective needed
                y = magnitude_prox_cols(ax, b_loc, c["m_dual"], mu)
            else:
                y = magnitude_prox_cols_elem(ax, b_loc, c["m_dual"], mu)
            aty = psum_p(matmul(y, a_conj))
            z_in = Pair(x.re + c["n_dual"].re * inv_mu,
                        x.im + c["n_dual"].im * inv_mu)
            z, v_basis = z_prox(z_in, mu, c["v_basis"])
            j_m = Pair(ax.re - y.re, ax.im - y.im)
            m_dual = Pair(c["m_dual"].re + mu * j_m.re,
                          c["m_dual"].im + mu * j_m.im)
            j_n = Pair(x.re - z.re, x.im - z.im)
            n_dual = Pair(c["n_dual"].re + mu * j_n.re,
                          c["n_dual"].im + mu * j_n.im)

            if scale_by_row:
                amp2 = jnp.sum(ax.re ** 2 + ax.im ** 2, axis=-2)
                obj = jnp.sqrt(psum(jnp.sum(
                    (jnp.sqrt(jnp.maximum(amp2, 0.0)) - b_loc) ** 2)))
                better = obj < c["opt_obj"]
                opt_x = Pair(jnp.where(better, x.re, c["opt_x"].re),
                             jnp.where(better, x.im, c["opt_x"].im))
                opt_y = Pair(jnp.where(better, y.re, c["opt_y"].re),
                             jnp.where(better, y.im, c["opt_y"].im))
                opt_obj = jnp.minimum(obj, c["opt_obj"])
            else:
                amp = jnp.sqrt(jnp.maximum(ax.re ** 2 + ax.im ** 2, 0.0))
                objs = jnp.sqrt(psum(jnp.sum(
                    (amp - b_loc[None, :]) ** 2, axis=-1)))
                j = jnp.argmin(objs)
                obj = objs[j]
                better = obj < c["opt_obj"]
                opt_x = Pair(jnp.where(better, x.re[j], c["opt_x"].re),
                             jnp.where(better, x.im[j], c["opt_x"].im))
                opt_y = Pair(jnp.where(better, y.re[j], c["opt_y"].re),
                             jnp.where(better, y.im[j], c["opt_y"].im))
                opt_obj = jnp.minimum(obj, c["opt_obj"])

            # residuals (ref :363-375); row-dim norms psum'd, n-dim local
            def loc2(p: Pair):
                return jnp.sum(p.re ** 2 + p.im ** 2)

            nax2, ny2 = gnorm2(ax), gnorm2(y)
            nx2, nz2 = loc2(x), loc2(z)
            naty2 = loc2(aty)
            res_prim = jnp.sqrt(gnorm2(j_m) + loc2(j_n))
            res_dual = mu * jnp.sqrt(
                loc2(Pair(aty.re - aty0.re, aty.im - aty0.im))
                + loc2(Pair(z.re - z0.re, z.im - z0.im)))
            res_comb = jnp.sqrt(
                res_prim ** 2 + gnorm2(Pair(y.re - y0.re, y.im - y0.im))
                + loc2(Pair(z.re - z0.re, z.im - z0.im)))
            t_prim = (cfg.tol_abs * math.sqrt((m_global + n) * rr)
                      + cfg.tol_rel * jnp.sqrt(jnp.maximum(nax2, ny2)
                                               + jnp.maximum(nx2, nz2)))
            t_dual = (cfg.tol_abs * math.sqrt(n * rr * 2)
                      + cfg.tol_rel * jnp.sqrt(naty2 + nz2))
            t_comb = (cfg.tol_abs * math.sqrt((m_global + n) * rr * 2)
                      + cfg.tol_rel * jnp.sqrt(jnp.maximum(nax2, ny2)
                                               + jnp.maximum(nx2, nz2)
                                               + ny2 + nz2))
            done = jnp.logical_or(
                jnp.logical_and(res_prim < t_prim, res_dual < t_dual),
                res_comb < t_comb)
            mu = jnp.where(res_comb > c["last_res"] * 0.9, mu * cfg.rho, mu)
            return dict(y=y, z=z, m_dual=m_dual, n_dual=n_dual, aty=aty,
                        v_basis=v_basis, mu=mu, last_res=res_comb,
                        opt_obj=opt_obj, opt_x=opt_x, opt_y=opt_y,
                        it=c["it"] + 1, done=done)

        if warm_iters > 0:
            warm_bound = min(warm_iters, cfg.maxiter)

            def cond_warm(c):
                return jnp.logical_and(c["it"] < warm_bound,
                                       jnp.logical_not(c["done"]))

            with jax.default_matmul_precision("default"):
                init = lax.while_loop(cond_warm, body, init)
            init = dict(init, done=jnp.zeros_like(init["done"]),
                        opt_obj=jnp.full_like(init["opt_obj"], jnp.inf))

        out = lax.while_loop(cond, body, init)
        return out["opt_x"], out["opt_y"]

    return admm


def _orthonormalize_sharded(x: Pair) -> Pair:
    """Column orthonormalization: replicated r x r Gram eig (ref :263-264)."""
    g = matmul(Pair(x.re, -x.im), _t(x))
    g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
    _, v_emb = eigh_jacobi(embed_hermitian(g))
    vecs = v_emb[:, 0::2]
    v_c = Pair(vecs[:x.shape[0]], vecs[x.shape[0]:])
    return matmul(_t(v_c), x)


def _solve_one_pair(a_loc: Pair, b_loc, nt: int, nr: int, cfg: AdmmConfig,
                    axis, m_global: int, prox_kind: str = "spectral_profile"):
    """One recovery with measurement rows sharded over ``axis`` — the
    REDUCED scaffold (no CV restarts / quality gate / rank-1 retry /
    rollback); see :func:`_solve_multi_one_pair` for the production one.

    ``a_loc``: (m_loc, n) Pair; ``b_loc``: (m_loc,).  Replicated state (X,
    Z, duals over n, U, the warm eigenbasis) is computed identically on
    every shard; row-local state (Y, M-dual) stays sharded.
    """
    psum, psum_p, gnorm2 = _psum_helpers(axis)
    m_loc, n = a_loc.shape
    r = min(cfg.rank, m_global, n)

    # ---- normalization (ref: inferLowRankV4_multi.m:27-38)
    a_norm = jnp.sqrt(gnorm2(a_loc) / m_global)
    a_norm = jnp.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    b_norm = jnp.sqrt(psum(jnp.sum(b_loc * b_loc)))
    b_norm = jnp.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    a_loc = Pair(a_loc.re / a_norm, a_loc.im / a_norm)
    b_loc = b_loc / b_norm

    u_conj = _precompute_u_sharded(a_loc, psum_p)
    xs = _spectral_init_sharded(a_loc, b_loc, r, psum_p)

    ladder = profile_ladder(nt, nr, m_global, n, False,
                            cfg.profile.rank_mults, cfg.profile.fractions,
                            mode=cfg.profile.ladder)
    admm = _make_admm(a_loc, b_loc, u_conj, ladder, cfg, psum, psum_p,
                      gnorm2, m_global, nt, nr, prox_kind)

    # ---- inferLowRankImpl scaffold (ref :111-271), no CV restarts
    x, _ = admm(xs, scale_by_row=True)
    x = _orthonormalize_sharded(x)
    x, _ = admm(x, scale_by_row=False)
    # full-data polish (ref :89-101 refinement, without rollback)
    x, _ = admm(Pair(x.re[None, :], x.im[None, :]), scale_by_row=True)
    s = b_norm / a_norm
    return Pair(x.re[0] * s, x.im[0] * s)


def _solve_multi_one_pair(a_loc: Pair, b_loc, key, nt: int, nr: int,
                          cfg: AdmmConfig, axis, m_global: int,
                          prox_kind: str = "spectral_profile"):
    """The PRODUCTION ``inferLowRankV4_multi`` scaffold with row-sharded
    inner solves (ref: inferLowRankV4_multi.m:5-109): CV restarts with the
    95/5 train/test split, held-out quality gate, rank-1 retry, best-restart
    selection, full-data refinement with similarity rollback.

    Row subsets are realized as 0/1 row MASKS instead of gathers: a masked
    row (A_i = 0, b_i = 0) contributes nothing to any Gram/psum/prox (the
    solver's inactive-row contract), so each shard keeps its contiguous row
    slice and no cross-shard gather is needed for the splits.  Per-restart
    U = inv(A_tr^H A_tr + I) is recomputed from the masked Gram.

    Deviation (documented): the rank-1 retry is a traced ``lax.cond``
    rather than the single-chip batch solver's host-gathered staging —
    host gathering across a sharded mesh would serialize the batch; under
    a batch vmap the cond lowers to a select that also runs the retry for
    converged instances (same trade as the pre-r04 single-jit form).
    """
    psum, psum_p, gnorm2 = _psum_helpers(axis)
    m_loc, n = a_loc.shape
    r = min(cfg.rank, m_global, n)
    thr = cfg.quality_threshold
    pl = cfg.profile
    n_restarts = cfg.n_restarts

    # ---- global normalization (ref :27-38)
    a_norm = jnp.sqrt(gnorm2(a_loc) / m_global)
    a_norm = jnp.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    b_norm = jnp.sqrt(psum(jnp.sum(b_loc * b_loc)))
    b_norm = jnp.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    a_loc = Pair(a_loc.re / a_norm, a_loc.im / a_norm)
    b_loc = b_loc / b_norm

    # local row offset of this shard (masks are computed on global indices)
    if axis is None:
        row0 = 0
    else:
        row0 = lax.axis_index(axis) * m_loc
    local_ids = row0 + jnp.arange(m_loc)

    lm_tr = int(math.floor(m_global * cfg.cc_frac))
    lad_tr = profile_ladder_arrays(nt, nr, lm_tr, n, False, pl.rank_mults,
                                   pl.fractions, mode=pl.ladder)
    lad_tr_r1 = profile_ladder_arrays(nt, nr, lm_tr, n, True, pl.rank_mults,
                                      pl.fractions, mode=pl.ladder)
    lad_full = profile_ladder_arrays(nt, nr, m_global, n, False,
                                     pl.rank_mults, pl.fractions,
                                     mode=pl.ladder)
    lad_full_r1 = profile_ladder_arrays(nt, nr, m_global, n, True,
                                        pl.rank_mults, pl.fractions,
                                        mode=pl.ladder)

    def quality(a_m: Pair, b_m, x: Pair):
        """1 - ||(|A_te x|) - b_te|| / ||b_te|| over masked test rows
        (ref :68)."""
        if x.re.ndim == 1:
            x = Pair(x.re[None, :], x.im[None, :])
        ax = matmul(x, _t(a_m))                           # (1, m_loc)
        amp = jnp.sqrt(jnp.maximum(ax.re ** 2 + ax.im ** 2, 0.0))[0]
        num = jnp.sqrt(psum(jnp.sum((amp - b_m) ** 2 * (b_m > 0))))
        den = jnp.sqrt(psum(jnp.sum(b_m * b_m)))
        return 1.0 - num / jnp.maximum(den, 1e-30)

    def one_restart(k_init, train_mask_g):
        """``k_init``: replicated per-restart key seeding the spectral
        init's orthogonal iteration (restart diversity, matching the
        single-chip scaffold); ``train_mask_g``: (m_global,) replicated
        0/1 mask."""
        tr = train_mask_g[local_ids]                      # (m_loc,)
        a_tr = Pair(a_loc.re * tr[:, None], a_loc.im * tr[:, None])
        b_tr = b_loc * tr
        te = 1.0 - tr
        a_te = Pair(a_loc.re * te[:, None], a_loc.im * te[:, None])
        b_te = b_loc * te

        u_tr = _precompute_u_sharded(a_tr, psum_p)
        xs = _spectral_init_sharded(a_tr, b_tr, r, psum_p, key=k_init)

        def run(ladder):
            # first-pass solves take the warm phase; the full-data
            # refinement below deliberately does not (it starts from an
            # already-converged x, which coarse iterations would degrade
            # before the f32 tail re-converges it — same policy as the
            # single-chip scaffold)
            admm = _make_admm(a_tr, b_tr, u_tr, ladder, cfg, psum, psum_p,
                              gnorm2, lm_tr, nt, nr, prox_kind,
                              warm_iters=cfg.warm_iters)
            x, _ = admm(xs, scale_by_row=True)
            x = _orthonormalize_sharded(x)
            x, _ = admm(x, scale_by_row=False)
            return x

        x = run(lad_tr)
        q = quality(a_te, b_te, x)
        if prox_kind != "nuclear":
            poor = q < thr

            def retry():
                xr = run(lad_tr_r1)
                return xr, quality(a_te, b_te, xr)

            x, q = lax.cond(poor, retry, lambda: (x, q))
            rank_one = poor
        else:
            rank_one = jnp.asarray(False)
        return x, q, rank_one

    def restart_inputs(i):
        # same per-restart PRNG derivation as the unsharded pair solver
        # (_solve_lowrank_core): fold_in(key, i) -> split; [0] drives the
        # train/test permutation (masks replace the gathered index
        # vectors), [1] seeds the spectral initialization
        k_split, k_init = jax.random.split(jax.random.fold_in(key, i))
        perm = jax.random.permutation(k_split, m_global)
        train_mask = jnp.zeros((m_global,), jnp.float32).at[
            perm[:lm_tr]].set(1.0)
        return k_init, train_mask

    # the restarts run as one vmapped batch, as in the single-device
    # solver (one copy of the restart graph, not n_restarts); the fold
    # below keeps the sequential selection: the first restart with the
    # strictly highest quality wins
    k_inits, masks = zip(*(restart_inputs(i) for i in range(n_restarts)))
    xs_r, qs_r, r1_r = jax.vmap(one_restart)(jnp.stack(k_inits),
                                             jnp.stack(masks))
    best = None
    for i in range(n_restarts):
        x, q, rank_one = Pair(xs_r.re[i], xs_r.im[i]), qs_r[i], r1_r[i]
        if best is None:
            best = (x, q, rank_one)
        else:
            better = q > best[1]
            best = (Pair(jnp.where(better, x.re, best[0].re),
                         jnp.where(better, x.im, best[0].im)),
                    jnp.maximum(q, best[1]),
                    jnp.where(better, rank_one, best[2]))
    x_max, q_max, rank_one = best
    x_max = Pair(x_max.re[None, :], x_max.im[None, :])    # (1, n)

    # full-data refinement with the rank-one flag selecting ladder DATA
    # (ref :89-101); similarity rollback below
    if prox_kind != "nuclear":
        lad_ref = LadderArrays(
            jnp.where(rank_one, lad_full_r1.ranks, lad_full.ranks),
            jnp.where(rank_one, lad_full_r1.fracs, lad_full.fracs))
    else:
        lad_ref = lad_full
    u_full = _precompute_u_sharded(a_loc, psum_p)
    admm_full = _make_admm(a_loc, b_loc, u_full, lad_ref, cfg, psum, psum_p,
                           gnorm2, m_global, nt, nr, prox_kind)
    x_ref, _ = admm_full(x_max, scale_by_row=True)

    dot_re = jnp.sum(x_max.re * x_ref.re + x_max.im * x_ref.im)
    dot_im = jnp.sum(x_max.re * x_ref.im - x_max.im * x_ref.re)

    def fro(p):
        return jnp.sqrt(jnp.sum(p.re ** 2 + p.im ** 2))

    similarity = (jnp.sqrt(dot_re ** 2 + dot_im ** 2)
                  / jnp.maximum(fro(x_max) * fro(x_ref), 1e-30))
    rollback = jnp.logical_and(q_max > thr,
                               similarity < cfg.similarity_threshold)
    x = Pair(jnp.where(rollback, x_max.re, x_ref.re),
             jnp.where(rollback, x_max.im, x_ref.im))
    s = b_norm / a_norm
    return Pair(x.re[0] * s, x.im[0] * s), q_max


@partial(jax.jit, static_argnames=("mesh", "nt", "nr", "cfg", "prox_kind"))
def solve_lowrank_multi_sharded_pair(mesh: Mesh, keys, a: Pair, b,
                                     nt: int, nr: int,
                                     cfg: AdmmConfig = AdmmConfig(),
                                     prox_kind: str = "spectral_profile"):
    """Batch of PRODUCTION-scaffold recoveries over a (batch x rows) mesh.

    The row-sharded twin of :func:`..ops.pair_solver.solve_lowrank_multi_pair`
    — CV restarts, held-out quality gate, rank-1 retry, best-restart
    selection, full-data refinement with similarity rollback
    (ref: inferLowRankV4_multi.m:5-109) — so a multi-chip deployment runs
    the SAME algorithm as the single-chip solver (see
    :func:`_solve_multi_one_pair` for the mask-based split realization).

    ``keys``: (B, 2) uint32 per-instance PRNG keys; ``a``: (B, m, n) Pair;
    ``b``: (B, m).  Returns ``(x (B, n) Pair, quality (B,))``, replicated
    over rows and sharded over batch.

    Contract: problems must be UNPADDED (every one of the m rows active).
    Normalization, the CV permutation, and the train-split size are all
    computed from ``m`` directly; the single-chip batch solver's b==0
    padding convention is NOT honored here — zero rows would shift the
    95/5 split and the 1/m normalization silently.
    """
    m_global = a.shape[1]

    def local_fn(keys_l, a_l, b_l):
        def solve(k, ai, bi):
            return _solve_multi_one_pair(ai, bi, k, nt, nr, cfg,
                                         axis=ROWS_AXIS, m_global=m_global,
                                         prox_kind=prox_kind)
        return jax.vmap(solve)(keys_l, a_l, b_l)

    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(BATCH_AXIS),
                             P(BATCH_AXIS, ROWS_AXIS, None),
                             P(BATCH_AXIS, ROWS_AXIS)),
                   out_specs=(P(BATCH_AXIS, None), P(BATCH_AXIS)),
                   check_vma=False)
    with jax.default_matmul_precision(cfg.matmul_precision):
        return fn(keys, a, b)


@partial(jax.jit, static_argnames=("mesh", "nt", "nr", "cfg", "prox_kind"))
def solve_lowrank_sharded_pair(mesh: Mesh, a: Pair, b, nt: int, nr: int,
                               cfg: AdmmConfig = AdmmConfig(),
                               prox_kind: str = "spectral_profile") -> Pair:
    """Batch of pair-form recoveries over a (batch x rows) mesh.

    ``a``: (B, m, n) Pair; ``b``: (B, m) float32.  Returns (B, n) Pair,
    replicated over rows and sharded over batch.  The pair twin of
    :func:`.sharded_admm.solve_lowrank_sharded`.
    """
    m_global = a.shape[1]

    def local_fn(a_l, b_l):
        solve = partial(_solve_one_pair, nt=nt, nr=nr, cfg=cfg,
                        axis=ROWS_AXIS, m_global=m_global,
                        prox_kind=prox_kind)
        return jax.vmap(solve)(a_l, b_l)

    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(BATCH_AXIS, ROWS_AXIS, None),
                             P(BATCH_AXIS, ROWS_AXIS)),
                   out_specs=P(BATCH_AXIS, None),
                   check_vma=False)
    # same precision policy as the unsharded solvers (config.AdmmConfig)
    with jax.default_matmul_precision(cfg.matmul_precision):
        return fn(a, b)
