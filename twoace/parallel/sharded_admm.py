"""Row-sharded + batch-sharded 2ACE ADMM (shard_map / pjit path).

SURVEY §2.8 mapping: measurement rows of A are independent in the magnitude
prox and couple only through ``A^H (...)`` in the X-update — so rows shard
cleanly over a mesh axis with one ``psum`` per iteration, while independent
problem instances shard over the batch axis with no communication at all
(the parfor replacement).

This module provides the complex-dtype sharded solver:
  - :func:`solve_lowrank_sharded` — batch of (A, B) problems over a
    (batch x rows) mesh, each solve row-sharded internally.

THE PRODUCTION MULTI-CHIP ENTRY IS THE PAIR TWIN:
:func:`.sharded_pair.solve_lowrank_multi_sharded_pair` runs the complete
``inferLowRankV4_multi`` scaffold (CV restarts, quality gate, rank-1
retry, rollback) with row-sharded inner solves, in the (re, im) float32
representation of the production solvers.
This complex twin keeps the REDUCED scaffold (spectral init -> over-param
ADMM -> orthonormalize -> column refinement -> full-data polish, no CV
restarts) as the CPU-friendly reference/debug path; maintaining the full
scaffold in both dtypes would invite drift, and complex64 does not run on
the production hardware anyway.  Collectives: one psum per X-update, one
for spectral init, one per residual evaluation.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import AdmmConfig
from ..ops.eigh_jacobi import eigh_desc
from ..ops.prox import (
    magnitude_prox,
    nuclear_prox,
    profile_ladder,
    project_rows_to_magnitude,
    spectral_profile_prox,
)
from .mesh import BATCH_AXIS, ROWS_AXIS


def _solve_one(a_loc, b_loc, nt: int, nr: int, cfg: AdmmConfig,
               prox_kind: str, axis: Optional[str], m_global: int):
    """Solve one instance with rows sharded over ``axis`` (None = no mesh).

    ``a_loc``: (m_loc, n); ``b_loc``: (m_loc,).  All replicated quantities
    (X, Z, N, U, norms) are computed identically on every shard.
    """
    if axis is None:
        def psum(v):
            return v
    else:
        def psum(v):
            return lax.psum(v, axis)

    m_loc, n = a_loc.shape
    r = min(cfg.rank, m_global, n)
    rdt = jnp.finfo(a_loc.dtype).dtype
    ah = jnp.conj(a_loc.T)

    def gnorm2(x_local):
        return psum(jnp.sum(jnp.abs(x_local) ** 2))

    # ---- normalization (ref: inferLowRankV4_multi.m:27-38)
    a_norm = jnp.sqrt(gnorm2(a_loc) / m_global)
    a_norm = jnp.where(a_norm < cfg.tol_abs, 1.0, a_norm)
    b_norm = jnp.sqrt(gnorm2(b_loc))
    b_norm = jnp.where(b_norm < cfg.tol_abs, 1.0, b_norm)
    a_loc = a_loc / a_norm.astype(a_loc.dtype)
    b_loc = b_loc / b_norm

    # ---- U = inv(A'A + I): Gram via psum, replicated Cholesky
    gram = psum(ah @ a_loc)
    gram = 0.5 * (gram + jnp.conj(gram.T)) + jnp.eye(n, dtype=a_loc.dtype)
    chol = jnp.linalg.cholesky(gram)
    eye = jnp.eye(n, dtype=a_loc.dtype)
    wtri = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    u_mat = jnp.conj(wtri.T) @ wtri

    # ---- spectral init (ref :561-574): row scaling local, Gram psum
    row_norm = jnp.linalg.norm(a_loc, axis=-1)
    scal = jnp.where(row_norm > 0, b_loc / jnp.maximum(row_norm, 1e-30), 1.0)
    a_s = a_loc * scal[:, None].astype(a_loc.dtype)
    g_s = psum(jnp.conj(a_s.T) @ a_s)
    w_s, v_s = eigh_desc(0.5 * (g_s + jnp.conj(g_s.T)), backend="xla")
    xs = v_s[:, :r] * jnp.sqrt(jnp.maximum(w_s[:r], 0.0))[None, :].astype(
        a_loc.dtype)

    if prox_kind == "nuclear":
        def prox(z, mu):
            return nuclear_prox(z, 1.0 / mu)
    else:
        ladder = profile_ladder(nt, nr, m_global, n, False,
                                cfg.profile.rank_mults, cfg.profile.fractions,
                                mode=cfg.profile.ladder)

        def prox(z, mu):
            return spectral_profile_prox(z, nt, nr, ladder)

    def admm(x0, scale_by_row: bool):
        """Row-sharded InferADMM (ref :281-386)."""
        rr = x0.shape[1]
        ax = a_loc @ x0
        if scale_by_row:
            x = x0 * (jnp.sqrt(gnorm2(b_loc) / jnp.maximum(gnorm2(ax), 1e-30))
                      ).astype(a_loc.dtype)
        else:
            col = jnp.sqrt(psum(jnp.sum(jnp.abs(ax) ** 2, axis=0)))
            x = x0 * (jnp.sqrt(gnorm2(b_loc)) /
                      jnp.maximum(col, 1e-30)).astype(a_loc.dtype)[None, :]
        ax = a_loc @ x
        y = project_rows_to_magnitude(ax, b_loc, scale_by_row)
        aty = psum(ah @ y)
        z = prox(x, jnp.asarray(1.0, rdt))
        m_dual = jnp.zeros((m_loc, rr), a_loc.dtype)
        n_dual = jnp.zeros((n, rr), a_loc.dtype)
        if scale_by_row:
            opt_x = jnp.zeros((n, rr), a_loc.dtype)
            opt_y = jnp.zeros((m_loc, rr), a_loc.dtype)
        else:
            opt_x = jnp.zeros((n,), a_loc.dtype)
            opt_y = jnp.zeros((m_loc,), a_loc.dtype)

        init = dict(y=y, z=z, m_dual=m_dual, n_dual=n_dual, aty=aty,
                    mu=jnp.asarray(cfg.mu0, rdt),
                    last_res=jnp.asarray(jnp.inf, rdt),
                    opt_obj=jnp.asarray(jnp.inf, rdt),
                    opt_x=opt_x, opt_y=opt_y,
                    it=jnp.asarray(0, jnp.int32), done=jnp.asarray(False))

        def cond(c):
            return jnp.logical_and(c["it"] < cfg.maxiter,
                                   jnp.logical_not(c["done"]))

        def body(c):
            y0, z0, aty0 = c["y"], c["z"], c["aty"]
            mu = c["mu"]
            muc = mu.astype(a_loc.dtype)
            # X-update: local partial matmul + psum (the rows collective)
            rhs = psum(ah @ (y0 - c["m_dual"] / muc)) \
                + (z0 - c["n_dual"] / muc)
            x = u_mat @ rhs
            ax = a_loc @ x
            y = magnitude_prox(ax, b_loc, c["m_dual"], mu, scale_by_row)
            aty = psum(ah @ y)
            z = prox(x + c["n_dual"] / muc, mu)
            j_m = ax - y
            m_dual = c["m_dual"] + muc * j_m
            j_n = x - z
            n_dual = c["n_dual"] + muc * j_n

            if scale_by_row:
                obj = jnp.sqrt(psum(jnp.sum(
                    (jnp.sqrt(jnp.sum(jnp.abs(ax) ** 2, 1)) - b_loc) ** 2)))
                better = obj < c["opt_obj"]
                opt_x = jnp.where(better, x, c["opt_x"])
                opt_y = jnp.where(better, y, c["opt_y"])
                opt_obj = jnp.minimum(obj, c["opt_obj"])
            else:
                objs = jnp.sqrt(psum(jnp.sum(
                    (jnp.abs(ax) - b_loc[:, None]) ** 2, axis=0)))
                j = jnp.argmin(objs)
                obj = objs[j]
                better = obj < c["opt_obj"]
                opt_x = jnp.where(better, x[:, j], c["opt_x"])
                opt_y = jnp.where(better, y[:, j], c["opt_y"])
                opt_obj = jnp.minimum(obj, c["opt_obj"])

            # residuals (ref :363-375); row-dim norms psum'd
            nax2, ny2 = gnorm2(ax), gnorm2(y)
            nx2, nz2 = jnp.sum(jnp.abs(x) ** 2), jnp.sum(jnp.abs(z) ** 2)
            naty2 = jnp.sum(jnp.abs(aty) ** 2)
            res_prim = jnp.sqrt(gnorm2(j_m) + jnp.sum(jnp.abs(j_n) ** 2))
            res_dual = mu * jnp.sqrt(jnp.sum(jnp.abs(aty - aty0) ** 2)
                                     + jnp.sum(jnp.abs(z - z0) ** 2))
            res_comb = jnp.sqrt(res_prim ** 2 + gnorm2(y - y0)
                                + jnp.sum(jnp.abs(z - z0) ** 2))
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
                        mu=mu, last_res=res_comb, opt_obj=opt_obj,
                        opt_x=opt_x, opt_y=opt_y, it=c["it"] + 1, done=done)

        out = lax.while_loop(cond, body, init)
        return out["opt_x"], out["opt_y"]

    # ---- inferLowRankImpl scaffold (ref :111-271), no CV restarts
    x, _ = admm(xs, scale_by_row=True)
    g = jnp.conj(x.T) @ x
    _, v = eigh_desc(0.5 * (g + jnp.conj(g.T)))
    x = x @ v
    x, _ = admm(x, scale_by_row=False)
    # full-data polish (ref :89-101 refinement, without rollback)
    x, _ = admm(x[:, None], scale_by_row=True)
    x = x[:, 0]
    return x * (b_norm / a_norm).astype(a_loc.dtype)


@partial(jax.jit, static_argnames=("mesh", "nt", "nr", "cfg", "prox_kind"))
def solve_lowrank_sharded(mesh: Mesh, a, b, nt: int, nr: int,
                          cfg: AdmmConfig = AdmmConfig(),
                          prox_kind: str = "spectral_profile"):
    """Solve a batch of magnitude-only recoveries over a (batch x rows) mesh.

    ``a``: (B, m, n); ``b``: (B, m).  Returns ``x``: (B, n), replicated over
    the rows axis and sharded over batch.
    """
    m_global = a.shape[1]

    def local_fn(a_l, b_l):
        solve = partial(_solve_one, nt=nt, nr=nr, cfg=cfg,
                        prox_kind=prox_kind, axis=ROWS_AXIS,
                        m_global=m_global)
        return jax.vmap(solve)(a_l, b_l)

    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=(P(BATCH_AXIS, ROWS_AXIS, None),
                             P(BATCH_AXIS, ROWS_AXIS)),
                   out_specs=P(BATCH_AXIS, None),
                   check_vma=False)
    return fn(a, b)
