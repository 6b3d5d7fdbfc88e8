"""PhaseLift: trace-regularized PSD least squares for phase retrieval.

JAX replacement of the TFOCS ``solver_TraceLS`` path used by the
reference (ref: main/src/my_recovery_algorithms/MyPhaseLift.m:69-108):

    minimize_{X >= 0}  0.5 * || b - A(X) ||_2^2 + lam * trace(X)

with the lifted linear operator ``A(X)_i = a_i^T X conj(a_i)`` (so that
``A(x x^H) = |a_i^T x|^2``).

Two solvers:
  - ``phaselift_fista``: exact lifted accelerated proximal gradient; the
    prox of ``lam*tr + PSD-indicator`` is an eigenvalue soft-threshold.
    O(n^2) memory — fine up to n ~ 1k.
  - ``phaselift_bm``: Burer-Monteiro factored X = V V^H with V (n, k),
    plain gradient descent with momentum; scalable path for n ~ 10^3+
    (SURVEY §7 "hard parts": full lift at n=1024 is 10^6-dim).

Both are pure jitted functions; rank-1 extraction follows MyPhaseLift.m:106-107.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import PhaseLiftConfig


class PhaseLiftResult(NamedTuple):
    x: jax.Array          #: (n,) leading-eigvec extraction sqrt(w1) v1
    lifted: jax.Array     #: (n, n) the PSD iterate (or V V^H for BM)
    objective: jax.Array


def _apply_linop(a, x_lift):
    """A(X)_i = a_i^T X conj(a_i)."""
    return jnp.real(jnp.einsum("in,nm,im->i", a, x_lift, jnp.conj(a)))


def _adjoint(a, r):
    """Adjoint of `_apply_linop` under <X, Y> = Re tr(X^H Y):
    A*(r)[n, m] = sum_i r_i conj(a_i[n]) a_i[m]."""
    return jnp.einsum("in,i,im->nm", jnp.conj(a), r.astype(a.dtype), a)


def _lipschitz(a, iters: int = 16):
    """Power iteration on X -> A*(A(X)) for the FISTA step size."""
    n = a.shape[1]
    x = jnp.eye(n, dtype=a.dtype)

    def body(x, _):
        y = _adjoint(a, _apply_linop(a, x))
        return y / jnp.maximum(jnp.linalg.norm(y), 1e-30), None

    x, _ = lax.scan(body, x, None, length=iters)
    y = _adjoint(a, _apply_linop(a, x))
    return jnp.linalg.norm(y)


def _extract(x_lift):
    w, v = jnp.linalg.eigh(x_lift)
    return jnp.sqrt(jnp.maximum(w[-1], 0.0)).astype(v.dtype) * v[:, -1]


@partial(jax.jit, static_argnames=("cfg",))
def phaselift_fista(a, b, cfg: PhaseLiftConfig = PhaseLiftConfig()
                    ) -> PhaseLiftResult:
    """Accelerated proximal gradient on the lifted SDP.

    ``a``: (m, n) sensing rows; ``b``: (m,) *intensity* measurements (|y|^2),
    matching the reference's ``(measurements/2e5).^2*1e10`` input convention
    (ref: Recover_Channel.m:35).
    """
    m, n = a.shape
    b = jnp.real(b)
    t = 1.0 / _lipschitz(a)
    x0 = jnp.zeros((n, n), a.dtype)

    def prox(x, step):
        x = 0.5 * (x + jnp.conj(x.T))
        w, v = jnp.linalg.eigh(x)
        w = jnp.maximum(w - step * cfg.lam, 0.0)
        return (v * w.astype(v.dtype)) @ jnp.conj(v.T)

    def obj(x):
        return (0.5 * jnp.sum((b - _apply_linop(a, x)) ** 2)
                + cfg.lam * jnp.real(jnp.trace(x)))

    def body(carry, _):
        x, z, tk, last = carry
        r = _apply_linop(a, z) - b
        g = _adjoint(a, r)
        x_new = prox(z - (t * g.astype(a.dtype)), t)
        tk_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tk * tk))
        z_new = x_new + ((tk - 1.0) / tk_new).astype(a.dtype) * (x_new - x)
        delta = jnp.linalg.norm(x_new - x) / jnp.maximum(
            jnp.linalg.norm(x_new), 1e-30)
        return (x_new, z_new, tk_new, delta), None

    (x, _, _, _), _ = lax.scan(body, (x0, x0, jnp.asarray(1.0), 1.0), None,
                               length=cfg.max_iters)
    return PhaseLiftResult(x=_extract(x), lifted=x, objective=obj(x))


@partial(jax.jit, static_argnames=("cfg",))
def phaselift_bm(key, a, b, cfg: PhaseLiftConfig = PhaseLiftConfig()
                 ) -> PhaseLiftResult:
    """Burer-Monteiro factored PhaseLift: X = V V^H, V of shape (n, k).

    minimize_V 0.5 || b - A(V V^H) ||^2 + lam ||V||_F^2, Wirtinger-flow
    style: spectral initialization from the top-k eigenvectors of
    ``A^H diag(b) A`` (rescaled to match the mean measured intensity), then
    momentum gradient descent with a *scale-invariant decayed step*
    ``eta_t/(1+t/tau) * ||V||/||g||`` — robust across measurement-row
    conditioning (Gaussian rows and unit-norm 2-bit codebook rows alike),
    where a fixed Lipschitz step diverges on the quartic loss.  Avoids any
    n x n eigendecomposition in the loop, so it scales to large n
    (32x32 arrays and beyond).
    """
    m, n = a.shape
    b = jnp.real(b)
    k = cfg.bm_rank

    # spectral init (Wirtinger-flow style)
    y_mat = jnp.conj(a.T) @ (b[:, None].astype(a.dtype) * a)
    w0, u0 = jnp.linalg.eigh(0.5 * (y_mat + jnp.conj(y_mat.T)))
    v0 = u0[:, ::-1][:, :k] * jnp.sqrt(jnp.maximum(
        w0[::-1][:k], 0.0))[None, :].astype(a.dtype)
    p0 = jnp.sum(jnp.abs(a @ v0) ** 2, axis=1)
    v0 = v0 * jnp.sqrt(jnp.mean(b)
                       / jnp.maximum(jnp.mean(p0), 1e-30)).astype(a.dtype)

    def loss_grad(v):
        av = a @ v                                      # (m, k)
        ax = jnp.sum(jnp.abs(av) ** 2, axis=1)          # A(V V^H)
        r = ax - b
        # grad_V = 2 A^H diag(r) A V + 2 lam V
        g = 2.0 * (jnp.conj(a.T) @ (r[:, None].astype(a.dtype) * av)) \
            + 2.0 * cfg.lam * v
        return 0.5 * jnp.sum(r ** 2) + cfg.lam * jnp.sum(jnp.abs(v) ** 2), g

    def body(carry, it):
        v, mom = carry
        _, g = loss_grad(v)
        eta = 0.2 / (1.0 + it / 300.0)
        rel = (jnp.linalg.norm(v) / jnp.maximum(jnp.linalg.norm(g), 1e-30))
        mom = 0.9 * mom - (eta * rel).astype(a.dtype) * g
        return (v + mom, mom), None

    (v, _), _ = lax.scan(body, (v0, jnp.zeros_like(v0)),
                         jnp.arange(cfg.max_iters))
    # extract leading column by thin-Gram eig
    g = jnp.conj(v.T) @ v
    w, s = jnp.linalg.eigh(0.5 * (g + jnp.conj(g.T)))
    lead = (v @ s[:, -1]) / jnp.maximum(jnp.sqrt(w[-1]), 1e-30).astype(a.dtype)
    x = jnp.sqrt(jnp.maximum(w[-1], 0.0)).astype(a.dtype) * lead
    loss, _ = loss_grad(v)
    return PhaseLiftResult(x=x, lifted=v @ jnp.conj(v.T), objective=loss)


# ---------------------------------------------------------------------------
# pair-representation path (real (re, im) float32 pairs, like the A2
# production solvers)

class PairPhaseLiftResult(NamedTuple):
    x_re: jax.Array
    x_im: jax.Array
    objective: jax.Array


@partial(jax.jit, static_argnames=("cfg",))
def phaselift_bm_pair(key, a, b, cfg: PhaseLiftConfig = PhaseLiftConfig()
                      ) -> PairPhaseLiftResult:
    """Burer-Monteiro PhaseLift in (re, im) pair representation.

    Same algorithm as :func:`phaselift_bm` (spectral init + scale-invariant
    decayed-step momentum descent), expressed without complex dtypes: the
    factor rides in transposed (k, n) layout so every matmul keeps its
    contiguous dimension at n or m; the spectral init runs Cholesky-QR
    orthogonal iteration on the real embedding of ``A^H diag(b) A``.

    ``a``: Pair (m, n); ``b``: (m,) intensities.  Returns the rank-1
    extraction as (re, im).
    """
    from .cplx import Pair, add, embed_hermitian, matmul
    from .eigh_jacobi import eigh_jacobi
    from .pair_solver import _cholqr

    m, n = a.shape
    b = jnp.asarray(b, jnp.float32)
    k = cfg.bm_rank
    a_conj = Pair(a.re, -a.im)                                # (m, n)
    a_t = Pair(a.re.T, a.im.T)                                # (n, m)

    # ---- spectral init: top-k of A^H diag(b) A via orthogonal iteration
    # on the real symmetric embedding
    wa = Pair(a.re * b[:, None], a.im * b[:, None])
    y_mat = matmul(Pair(a_t.re, -a_t.im), wa)                 # A^H diag(b) A
    y_mat = Pair(0.5 * (y_mat.re + y_mat.re.T),
                 0.5 * (y_mat.im - y_mat.im.T))
    y_emb = embed_hermitian(y_mat)                            # (2n, 2n)
    q = jax.random.normal(key, (2 * n, 2 * k), jnp.float32)

    def oi_body(q, _):
        return _cholqr(y_emb @ q), None

    q, _ = lax.scan(oi_body, _cholqr(q), None, length=24)
    rr_mat = q.T @ (y_emb @ q)
    w0, s0 = eigh_jacobi(0.5 * (rr_mat + rr_mat.T))
    ritz = q @ s0
    w_r = jnp.sqrt(jnp.maximum(w0[0::2][:k], 0.0))
    vecs = ritz[:, 0::2][:, :k]
    v0 = Pair((vecs[:n] * w_r[None, :]).T, (vecs[n:] * w_r[None, :]).T)
    p0 = matmul(v0, a_t)
    p0 = jnp.sum(p0.re ** 2 + p0.im ** 2, axis=0)
    s_init = jnp.sqrt(jnp.mean(b) / jnp.maximum(jnp.mean(p0), 1e-30))
    v0 = Pair(v0.re * s_init, v0.im * s_init)

    def loss_grad(v: Pair):
        av = matmul(v, a_t)                                   # (k, m)
        ax = jnp.sum(av.re ** 2 + av.im ** 2, axis=0)         # intensities
        r = ax - b
        gv = matmul(Pair(av.re * r[None, :], av.im * r[None, :]), a_conj)
        g = Pair(2.0 * gv.re + 2.0 * cfg.lam * v.re,
                 2.0 * gv.im + 2.0 * cfg.lam * v.im)
        loss = 0.5 * jnp.sum(r ** 2) + cfg.lam * jnp.sum(v.re ** 2
                                                         + v.im ** 2)
        return loss, g

    def body(carry, it):
        v, mom = carry
        _, g = loss_grad(v)
        eta = 0.2 / (1.0 + it / 300.0)
        gn = jnp.sqrt(jnp.sum(g.re ** 2 + g.im ** 2))
        vn = jnp.sqrt(jnp.sum(v.re ** 2 + v.im ** 2))
        step = eta * vn / jnp.maximum(gn, 1e-30)
        mom = Pair(0.9 * mom.re - step * g.re, 0.9 * mom.im - step * g.im)
        return (add(v, mom), mom), None

    zero = Pair(jnp.zeros_like(v0.re), jnp.zeros_like(v0.im))
    (v, _), _ = lax.scan(body, (v0, zero), jnp.arange(cfg.max_iters))

    # rank-1 extraction via the k x k Gram on the real embedding
    from .cplx import embed_hermitian

    # g_cd = sum_n conj(v_cn) v_dn = (V^H V)_cd with V = v^T (n, k)
    g = matmul(Pair(v.re, -v.im), Pair(v.re.T, v.im.T))
    g = Pair(0.5 * (g.re + g.re.T), 0.5 * (g.im - g.im.T))
    w_emb, v_emb = eigh_jacobi(embed_hermitian(g))
    s = Pair(v_emb[:k, 0], v_emb[k:, 0])                      # top eigvec
    # x = V s1  ->  x^T = s1^T v  (no conjugate)
    lead = matmul(Pair(s.re[None, :], s.im[None, :]), v)      # (1, n)
    loss, _ = loss_grad(v)
    return PairPhaseLiftResult(x_re=lead.re[0], x_im=lead.im[0],
                               objective=loss)
