"""Pair-representation complex arithmetic: complex tensors as (re, im) pairs.

Why: the production solvers carry complex matrices as explicit ``(re, im)``
float32 pairs so every operation is a plain real matmul or elementwise op,
and every complex product runs as three real GEMMs (the 3M form below).
Whether native complex64 GEMMs beat this form on a GPU is an open
measurement (ROADMAP A4); :mod:`.admm` is the complex-dtype stack.

Contents:
  - pair matmuls (3-multiplication Karatsuba form), conjugate-transpose
    matmuls, elementwise helpers
  - pair-form magnitude prox (ArgMinY semantics,
    ref: inferLowRankV4_multi.m:511-533)
  - pair-form spectral-profile prox via the real symmetric *embedding*
    [[Hr, -Hi], [Hi, Hr]] of a Hermitian matrix: spectral functions commute
    with the embedding, so the prox runs a real Jacobi eigendecomposition
    (ref: inferLowRankV4_multi.m:423-485)
  - a fused pair-form 2ACE ADMM iteration (the benchmark/production step,
    ref loop: inferLowRankV4_multi.m:318-341)
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp

from .eigh_jacobi import eigh_jacobi


class Pair(NamedTuple):
    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape


class LadderArrays(NamedTuple):
    """Constraint ladder C(r, f) as *traced data* instead of static tuples.

    ``ranks``/``fracs`` are fixed-length (L,) float32 arrays (padded with
    no-op levels ``f = 0``: the ladder only acts when the head captures
    less than fraction f of the variance, so f = 0 never triggers).  As a
    pytree this flows through jit/vmap, which lets the quality-gated rank-1
    retry and the refinement's rank-one flag (ref:
    inferLowRankV4_multi.m:73-77,92-100) become a cheap per-instance
    ladder *select* instead of a second traced solver branch — under a
    batch vmap a ``lax.cond`` of two full solves lowers to a select that
    executes both, doubling the work.
    """

    ranks: jax.Array  #: (..., L) head sizes r_k (float32, compared as rank < r_k)
    fracs: jax.Array  #: (..., L) variance fractions f_k; 0 = padded no-op


def ladder_levels(ladder):
    """Normalize a ladder into an iterable of (rank, frac) levels.

    Accepts the static tuple-of-(int, float) form produced by
    :func:`..ops.prox.profile_ladder` or a traced :class:`LadderArrays`.
    """
    if isinstance(ladder, LadderArrays):
        length = ladder.ranks.shape[-1]
        return [(ladder.ranks[..., i], ladder.fracs[..., i])
                for i in range(length)]
    return list(ladder)


def from_complex(x) -> Pair:
    x = jnp.asarray(x)
    return Pair(jnp.real(x).astype(jnp.float32),
                jnp.imag(x).astype(jnp.float32))


def to_complex(p: Pair):
    return p.re + 1j * p.im


def add(a: Pair, b: Pair) -> Pair:
    return Pair(a.re + b.re, a.im + b.im)


def sub(a: Pair, b: Pair) -> Pair:
    return Pair(a.re - b.re, a.im - b.im)


def scale(a: Pair, s) -> Pair:
    """Multiply by a real scalar/array (broadcast)."""
    return Pair(a.re * s, a.im * s)


def conj(a: Pair) -> Pair:
    return Pair(a.re, -a.im)


def abs2(a: Pair):
    return a.re * a.re + a.im * a.im


def matmul(a: Pair, b: Pair) -> Pair:
    """A @ B with 3 real matmuls (Karatsuba 3M form):
    k1 = Ar(Br+Bi); k2 = (Ar+Ai)Bi; k3 = (Ai-Ar)Br;
    re = k1 - k2, im = k1 + k3."""
    k1 = a.re @ (b.re + b.im)
    k2 = (a.re + a.im) @ b.im
    k3 = (a.im - a.re) @ b.re
    return Pair(k1 - k2, k1 + k3)


def matmul_herm_t(a: Pair, b: Pair) -> Pair:
    """A^H @ B: (Ar^T - i Ai^T)(Br + i Bi)."""
    at = Pair(jnp.swapaxes(a.re, -1, -2), -jnp.swapaxes(a.im, -1, -2))
    return matmul(at, b)


def embed_hermitian(h: Pair):
    """Real symmetric embedding [[Hr, -Hi], [Hi, Hr]] of a Hermitian pair."""
    top = jnp.concatenate([h.re, -h.im], axis=-1)
    bot = jnp.concatenate([h.im, h.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def unembed(m, n: int) -> Pair:
    """Inverse of :func:`embed_hermitian` (averages the redundant blocks)."""
    return Pair(0.5 * (m[..., :n, :n] + m[..., n:, n:]),
                0.5 * (m[..., n:, :n] - m[..., :n, n:]))


def magnitude_prox_rows(ax: Pair, b, m_dual: Pair, mu) -> Pair:
    """Pair-form row-magnitude prox (scale_by_row=True ArgMinY).

    ``ax``, ``m_dual``: (m, r) pairs; ``b``: (m,) real.  Zero rows take the
    reference's constant-direction branch Y(I,:) = 1/sqrt(r), D(I) = 1
    (ref: inferLowRankV4_multi.m:511-523, zero branch :516-519).

    Rows with ``b == 0`` are INACTIVE: their exact prox is y = 0
    (objective (|y| - 0)^2 + mu |y - v|^2 with v = 0 for a zero A row).
    This is the masking hook for static-shape window padding (mobility
    tracking pads the sliding probe window with (A_i = 0, b_i = 0) rows so
    the solver compiles ONCE per run, ref: RSS_Mobility.m:155-188);
    real measured amplitudes are strictly positive, so the rule is inert
    for ordinary problems.
    """
    inv_mu = 1.0 / mu
    yr = ax.re + m_dual.re * inv_mu
    yi = ax.im + m_dual.im * inv_mu
    d2 = jnp.sum(yr * yr + yi * yi, axis=-1, keepdims=True)
    zero = d2 <= 0
    r = yr.shape[-1]
    yr = jnp.where(zero, 1.0 / math.sqrt(r), yr)
    yi = jnp.where(zero, 0.0, yi)
    d = jnp.sqrt(jnp.where(zero, 1.0, d2))
    coeff = (b[..., None] / d + mu) / (1.0 + mu) * (b[..., None] > 0)
    return Pair(yr * coeff, yi * coeff)


def spectral_profile_prox_pair(z: Pair, nt: int, nr: int,
                               ladder: Sequence[Tuple[int, float]],
                               sweeps: int = 6, v0=None,
                               return_basis: bool = False):
    """Pair-form 2ACE spectral-profile prox.

    Same semantics as :func:`..ops.prox.spectral_profile_prox`, but the
    (nr x nr) Hermitian Gram eigendecomposition runs on the real 2nr x 2nr
    symmetric embedding with the real Jacobi solver — no complex dtype
    anywhere.  Embedded eigenvalues come in duplicated pairs; the ladder is
    evaluated on the deduplicated (every other sorted) spectrum.

    ``v0``: optional warm-start eigenbasis (2nr, 2nr real orthogonal) from a
    previous call.  The Gram changes little between consecutive ADMM
    iterations, so congruence-transforming into the previous basis leaves a
    near-diagonal matrix that one cheap Jacobi sweep re-diagonalizes —
    the replacement for re-running a full eig per iteration
    (ref cost: inferLowRankV4_multi.m:428-430 runs MATLAB ``eig`` per iter).
    With ``return_basis=True`` returns ``(result, v)``.
    """
    n, r = z.shape
    # columns -> channel-panel E (nr, nt*r): z[:, c] k-index = it*nr + ir
    def to_panel(x):
        return x.T.reshape(r, nt, nr).transpose(2, 0, 1).reshape(nr, r * nt)

    def from_panel(e):
        return e.reshape(nr, r, nt).transpose(1, 2, 0).reshape(r, nt * nr).T

    e = Pair(to_panel(z.re), to_panel(z.im))
    e_new, v = _panel_spectral_prox(e, nr, ladder, sweeps, v0)
    out = Pair(from_panel(e_new.re), from_panel(e_new.im))
    if return_basis:
        return out, v
    return out


def magnitude_prox_cols(ax_t: Pair, b, m_dual_t: Pair, mu) -> Pair:
    """Transposed-layout row-magnitude prox (arrays are (r, m), b is (m,)).

    Same math as :func:`magnitude_prox_rows` with the over-parameterization
    axis r leading: the per-measurement-row norm reduces over axis -2.
    Zero measurement rows take the reference's constant branch
    (ref: inferLowRankV4_multi.m:516-519); rows with ``b == 0`` are
    inactive padding and prox to exactly 0 (see magnitude_prox_rows).
    """
    inv_mu = 1.0 / mu
    yr = ax_t.re + m_dual_t.re * inv_mu
    yi = ax_t.im + m_dual_t.im * inv_mu
    d2 = jnp.sum(yr * yr + yi * yi, axis=-2, keepdims=True)
    zero = d2 <= 0
    r = yr.shape[-2]
    yr = jnp.where(zero, 1.0 / math.sqrt(r), yr)
    yi = jnp.where(zero, 0.0, yi)
    d = jnp.sqrt(jnp.where(zero, 1.0, d2))
    coeff = (b[..., None, :] / d + mu) / (1.0 + mu) * (b[..., None, :] > 0)
    return Pair(yr * coeff, yi * coeff)


def eigh_update_perturbative(g, v0, ns_steps: int = 3,
                             rel_gap: float = 1e-3, max_norm: float = 0.7):
    """One warm-started eigenbasis refinement step (first-order perturbation).

    Given symmetric ``g`` (..., n, n) and an approximate eigenbasis ``v0``
    from the previous ADMM iteration, rotate ``g' = v0^T g v0`` (near
    diagonal), apply the Rayleigh-Schrodinger first-order eigenvector
    correction ``E_ij = g'_ij / (l_j - l_i)`` (masked on (near-)degenerate
    pairs — harmless here because the spectral-profile prox applies identical
    scaling inside a degenerate cluster), and re-orthonormalize with
    ``ns_steps`` Newton-Schulz iterations.  Total cost ~5 small matmuls vs a
    full Jacobi sweep's n-1 sequential rotation rounds — the latency-lean
    replacement for per-iteration ``eig`` in the jitted loop
    (ref cost: inferLowRankV4_multi.m:428-430).

    Returns ``(w, v)`` with eigenvalues **descending**.
    """
    n = g.shape[-1]
    gr = jnp.swapaxes(v0, -1, -2) @ (g @ v0)
    lam = jnp.diagonal(gr, axis1=-2, axis2=-1)
    gap = lam[..., None, :] - lam[..., :, None]         # l_j - l_i
    scale = jnp.abs(lam[..., None, :]) + jnp.abs(lam[..., :, None])
    ok = jnp.abs(gap) > rel_gap * jnp.maximum(scale, 1e-30)
    corr = jnp.where(ok, gr / jnp.where(ok, gap, 1.0), 0.0)
    # exact-first-order correction is skew (gr symmetric); project to skew
    # and cap ||C||_F <= max_norm so I + C stays in Newton-Schulz's basin
    # (sigma(V) <= sqrt(1 + max_norm^2) < sqrt(3)).  When the basis lags the
    # Gram badly (early iterations) the capped step moves partway and the
    # basis catches up over the next few iterations, tracking-filter style.
    corr = 0.5 * (corr - jnp.swapaxes(corr, -1, -2))
    fro = jnp.sqrt(jnp.sum(corr * corr, axis=(-2, -1), keepdims=True))
    corr = corr * jnp.minimum(1.0, max_norm / jnp.maximum(fro, 1e-30))
    eye = jnp.eye(n, dtype=g.dtype)
    v = v0 @ (eye + corr)
    for _ in range(ns_steps):
        vtv = jnp.swapaxes(v, -1, -2) @ v
        v = v @ (1.5 * eye - 0.5 * vtv)
    order = jnp.argsort(-lam, axis=-1)
    w = jnp.take_along_axis(lam, order, axis=-1)
    v = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    return w, v


def eigh_update_perturbative_pair(g: Pair, v0: Pair, ns_steps: int = 1,
                                  rel_gap: float = 1e-3,
                                  max_norm: float = 0.7):
    """Complex-pair warm eigenbasis refinement (no real embedding).

    Same scheme as :func:`eigh_update_perturbative` but directly on the
    Hermitian pair ``g`` (..., n, n) with a unitary pair basis ``v0``:
    rotate ``g' = v0^H g v0``, first-order anti-Hermitian correction
    ``C_ij = g'_ij / (l_j - l_i)`` (masked near degeneracy, Frobenius-capped),
    ``v = v0 (I + C)``, then ``ns_steps`` Newton-Schulz re-unitarizations.
    Working at size n instead of the 2n embedding roughly halves the
    sequential matmul latency of the ADMM Z-prox.

    Returns ``(lam, v)`` with lam the (UNSORTED) Rayleigh eigenvalue
    estimates aligned with v's columns.
    """
    n = g.shape[-1]
    gr = matmul_herm_t(v0, matmul(g, v0))                    # v0^H g v0
    lam = jnp.diagonal(gr.re, axis1=-2, axis2=-1)
    gap = lam[..., None, :] - lam[..., :, None]              # l_j - l_i
    mag = jnp.abs(lam[..., None, :]) + jnp.abs(lam[..., :, None])
    ok = jnp.abs(gap) > rel_gap * jnp.maximum(mag, 1e-30)
    denom = jnp.where(ok, gap, 1.0)
    c = Pair(jnp.where(ok, gr.re / denom, 0.0),
             jnp.where(ok, gr.im / denom, 0.0))
    # exact correction is anti-Hermitian; project and cap ||C||_F
    c = Pair(0.5 * (c.re - jnp.swapaxes(c.re, -1, -2)),
             0.5 * (c.im + jnp.swapaxes(c.im, -1, -2)))
    fro = jnp.sqrt(jnp.sum(c.re * c.re + c.im * c.im, axis=(-2, -1),
                           keepdims=True))
    capped = jnp.minimum(1.0, max_norm / jnp.maximum(fro, 1e-30))
    c = Pair(c.re * capped, c.im * capped)
    v = add(v0, matmul(v0, c))
    eye = jnp.eye(n, dtype=v.re.dtype)
    for _ in range(ns_steps):
        vtv = matmul_herm_t(v, v)
        v = matmul(v, Pair(1.5 * eye - 0.5 * vtv.re, -0.5 * vtv.im))
    return lam, v


def ladder_scales(w, ladder):
    """Per-eigenvalue multipliers of the 2ACE constraint ladder, computed on
    the UNSORTED spectrum ``w`` (..., k) and returned in the same order.

    The ladder semantics (ref: inferLowRankV4_multi.m:437-480) are defined on
    the descending spectrum.  Instead of sorting, each eigenvalue's rank is
    computed by pairwise comparison (a k x k boolean reduce — pure
    elementwise work, no gathers), and "head of the spectrum" becomes a
    rank mask.  The scale multipliers compose across ladder levels exactly
    as in the sorted formulation; the eigenvector matrix is never reordered.
    """
    k = w.shape[-1]
    # rank_i = #{j : w_j > w_i} with index tie-break for exact duplicates
    gt = w[..., None, :] > w[..., :, None]
    eq = w[..., None, :] == w[..., :, None]
    idx = jnp.arange(k)
    tie = jnp.logical_and(eq, idx[None, :] < idx[:, None])
    rank = jnp.sum(jnp.logical_or(gt, tie), axis=-1)          # (..., k)
    scale = jnp.ones_like(w)
    v_tot = jnp.sum(w, axis=-1)
    for rk, f in ladder_levels(ladder):
        head = rank < rk
        vr = jnp.sum(jnp.where(head, w, 0.0), axis=-1)
        need = vr < v_tot * f
        s = jnp.minimum(1.0, vr / jnp.maximum(v_tot - vr, 1e-30)
                        * (1.0 / jnp.maximum(f, 1e-30) - 1.0))
        s = jnp.where(need, s, 1.0)
        mult = jnp.where(head, 1.0, s[..., None])
        w = w * mult
        scale = scale * mult
        v_tot = jnp.sum(w, axis=-1)
    return scale


def panel_gram_basis_pair(e: Pair, sweeps: int = 8):
    """Cold complex-pair eigenbasis of the panel Gram E E^H, via one real
    Jacobi solve on the embedding (used to seed the warm perturbative
    Z-prox).  Returns ``(w, v)`` with w descending and v a unitary Pair."""
    nr = e.shape[-2]
    g = matmul(e, conj(Pair(jnp.swapaxes(e.re, -1, -2),
                            jnp.swapaxes(e.im, -1, -2))))
    g = Pair(0.5 * (g.re + jnp.swapaxes(g.re, -1, -2)),
             0.5 * (g.im - jnp.swapaxes(g.im, -1, -2)))
    w_emb, v_emb = eigh_jacobi(embed_hermitian(g), sweeps=sweeps)
    # every other embedded column [vr; vi] -> complex eigvec vr + i vi
    return (w_emb[..., 0::2],
            Pair(v_emb[..., :nr, 0::2], v_emb[..., nr:, 0::2]))


def _panel_spectral_prox_c(e: Pair, nr: int, ladder, v0):
    """Complex-pair spectral-profile prox (the fast warm path).

    ``v0``: unitary Pair basis from the previous iteration, or None for a
    cold start.  Returns ``(e_new, v)``.
    """
    if v0 is None:
        w, v = panel_gram_basis_pair(e)
    else:
        g = matmul(e, conj(Pair(jnp.swapaxes(e.re, -1, -2),
                                jnp.swapaxes(e.im, -1, -2))))
        g = Pair(0.5 * (g.re + jnp.swapaxes(g.re, -1, -2)),
                 0.5 * (g.im - jnp.swapaxes(g.im, -1, -2)))
        w, v = eigh_update_perturbative_pair(g, v0)
    scale = ladder_scales(jnp.maximum(w, 0.0), ladder)
    coeff = jnp.sqrt(scale) - 1.0
    vc = Pair(v.re * coeff[..., None, :], v.im * coeff[..., None, :])
    delta = matmul(vc, Pair(jnp.swapaxes(v.re, -1, -2),
                            -jnp.swapaxes(v.im, -1, -2)))      # vc @ v^H
    e_new = add(e, matmul(delta, e))
    return e_new, v


def _panel_spectral_prox(e: Pair, nr: int, ladder, sweeps: int, v0,
                         eig_mode: str = "jacobi"):
    """Spectral-profile prox on a channel panel ``e`` (nr, cols).

    Shared core of the pair-form Z-prox: Gram -> real symmetric embedding ->
    eigh (cold Jacobi, warm Jacobi, or warm perturbative update) ->
    constraint-ladder rescale -> low-rank delta applied back to ``e``.
    Returns ``(e_new, v)``.
    """
    g = matmul(e, conj(Pair(jnp.swapaxes(e.re, -1, -2),
                            jnp.swapaxes(e.im, -1, -2))))
    g = Pair(0.5 * (g.re + jnp.swapaxes(g.re, -1, -2)),
             0.5 * (g.im - jnp.swapaxes(g.im, -1, -2)))
    g_emb = embed_hermitian(g)
    if v0 is not None and eig_mode == "perturb":
        w, v = eigh_update_perturbative(g_emb, v0)
    elif v0 is not None:
        g_rot = jnp.swapaxes(v0, -1, -2) @ g_emb @ v0
        w, s_rot = eigh_jacobi(g_rot, sweeps=sweeps)
        v = v0 @ s_rot
    else:
        w, v = eigh_jacobi(g_emb, sweeps=sweeps)
    w = jnp.maximum(w, 0.0)
    w_c = w[..., 0::2]                              # deduplicated spectrum

    scale_c = jnp.ones_like(w_c)
    v_tot = jnp.sum(w_c, axis=-1)
    idx = jnp.arange(w_c.shape[-1])
    for rk, f in ladder_levels(ladder):
        vr = jnp.sum(jnp.where(idx < rk, w_c, 0.0), axis=-1)
        need = vr < v_tot * f
        s = jnp.minimum(1.0, vr / jnp.maximum(v_tot - vr, 1e-30)
                        * (1.0 / jnp.maximum(f, 1e-30) - 1.0))
        s = jnp.where(need, s, 1.0)
        mult = jnp.where(idx >= rk, s[..., None], 1.0)
        w_c = w_c * mult
        scale_c = scale_c * mult
        v_tot = jnp.sum(w_c, axis=-1)

    coeff = jnp.repeat(jnp.sqrt(scale_c) - 1.0, 2, axis=-1)
    delta_emb = (v * coeff[..., None, :]) @ jnp.swapaxes(v, -1, -2)
    delta = unembed(delta_emb, nr)
    e_new = add(e, matmul(delta, e))
    return e_new, v


def panel_gram_basis(z_t: Pair, nt: int, nr: int, sweeps: int = 8):
    """Eigenbasis (2nr, 2nr) of the embedded Z-prox Gram for warm-starting.

    ``z_t``: transposed-layout Z (..., r, nt*nr).  Run once before the ADMM
    loop when using ``eig_mode='perturb'`` — the perturbative update only
    refines an already-good basis, so seed it with a cold Jacobi solve.
    """
    r = z_t.shape[-2]
    lead = z_t.re.shape[:-2]

    def to_panel(xx):
        return xx.reshape(lead + (r, nt, nr)) \
                 .swapaxes(-1, -3).swapaxes(-1, -2) \
                 .reshape(lead + (nr, r * nt))

    e = Pair(to_panel(z_t.re), to_panel(z_t.im))
    g = matmul(e, conj(Pair(jnp.swapaxes(e.re, -1, -2),
                            jnp.swapaxes(e.im, -1, -2))))
    g = Pair(0.5 * (g.re + jnp.swapaxes(g.re, -1, -2)),
             0.5 * (g.im - jnp.swapaxes(g.im, -1, -2)))
    _, v = eigh_jacobi(embed_hermitian(g), sweeps=sweeps)
    return v


def admm_iteration_pair_t(a: Pair, b, u_mat: Pair, nt: int, nr: int,
                          ladder: Sequence[Tuple[int, float]],
                          sweeps: int = 1, eig_mode: str = "jacobi"):
    """Transposed-layout fused 2ACE ADMM iteration (the production layout).

    Identical math to :func:`admm_iteration_pair` with ``warm_basis=True``,
    but every state array carries the over-parameterization axis r *first*:
    y, m_dual are (r, m); z, n_dual are (r, n).  Why: with the reference's
    r = 20 (inferLowRankV4_multi.m:4) as the contiguous dimension, every
    matmul tile would be mostly padding.  Transposed, r rides the row
    dimension (folded with the batch under vmap) and the contiguous
    dimension is always n or m (256/1024 at production shape):

        rhs^T = t^T conj(A) + (z^T - n^T/mu)      (r,m)@(m,n)
        x^T   = rhs^T conj(U)                      (r,n)@(n,n)   [U Hermitian]
        (Ax)^T = x^T A^T                           (r,n)@(n,m)

    State: ``(y_t, z_t, m_t, n_t, mu, v_basis)``; v_basis is the warm
    eigenbasis of the Z-prox Gram.  ``eig_mode``:
      - "jacobi": warm Jacobi (``sweeps`` full sweeps) on the real (2nr, 2nr)
        embedding; seed v_basis with ``jnp.eye(2*nr)``.
      - "perturb": first-order perturbative basis update, lowest latency.
        Seed v_basis with a *Pair* basis from :func:`panel_gram_basis_pair`
        for the fast complex-pair path (n-sized matmuls), or with a real
        (2nr, 2nr) basis for the embedding variant.
    """
    a_conj = Pair(a.re, -a.im)                                # (m, n)
    a_t = Pair(jnp.swapaxes(a.re, -1, -2),
               jnp.swapaxes(a.im, -1, -2))                    # (n, m)
    u_conj = Pair(u_mat.re, -u_mat.im)                        # U^T = conj(U)

    def step(state):
        y, z, m_dual, n_dual, mu, v_basis = state
        inv_mu = 1.0 / mu
        t = Pair(y.re - m_dual.re * inv_mu, y.im - m_dual.im * inv_mu)
        rhs = add(matmul(t, a_conj), Pair(z.re - n_dual.re * inv_mu,
                                          z.im - n_dual.im * inv_mu))
        x = matmul(rhs, u_conj)                               # (r, n)
        ax = matmul(x, a_t)                                   # (r, m)
        y_new = magnitude_prox_cols(ax, b, m_dual, mu)
        z_in = Pair(x.re + n_dual.re * inv_mu, x.im + n_dual.im * inv_mu)
        # (r, nt*nr) -> panel (nr, r*nt): k = it*nr + ir
        r = z.shape[-2]

        def to_panel(xx):
            return xx.reshape(r, nt, nr).transpose(2, 0, 1).reshape(
                nr, r * nt)

        def from_panel(ee):
            return ee.reshape(nr, r, nt).transpose(1, 2, 0).reshape(
                r, nt * nr)

        e = Pair(to_panel(z_in.re), to_panel(z_in.im))
        if eig_mode == "perturb" and (v_basis is None
                                      or isinstance(v_basis, Pair)):
            e_new, v_new = _panel_spectral_prox_c(e, nr, ladder, v_basis)
        else:
            e_new, v_new = _panel_spectral_prox(e, nr, ladder, sweeps,
                                                v_basis, eig_mode=eig_mode)
        z_new = Pair(from_panel(e_new.re), from_panel(e_new.im))
        m_new = Pair(m_dual.re + mu * (ax.re - y_new.re),
                     m_dual.im + mu * (ax.im - y_new.im))
        n_new = Pair(n_dual.re + mu * (x.re - z_new.re),
                     n_dual.im + mu * (x.im - z_new.im))
        return (y_new, z_new, m_new, n_new, mu * 1.03, v_new)

    return step


def admm_iteration_pair(a: Pair, b, u_mat: Pair, nt: int, nr: int,
                        ladder: Sequence[Tuple[int, float]],
                        sweeps: int = 6, warm_basis: bool = False):
    """Build the fused pair-form 2ACE ADMM iteration.

    Returns ``step(state) -> state`` with state =
    (y, z, m_dual, n_dual, mu) pairs/real — one full X/Y/Z/dual update
    (ref: inferLowRankV4_multi.m:318-341) in pure real arithmetic.

    ``warm_basis=True`` appends the Z-prox eigenbasis (2nr, 2nr) to the
    state and warm-starts each iteration's eigendecomposition from the
    previous one, so ``sweeps`` can drop to 1 with no accuracy loss on
    the slowly-varying ADMM Gram (initialize the extra state entry with
    ``jnp.eye(2 * nr)``).
    """
    ah = Pair(jnp.swapaxes(a.re, -1, -2), -jnp.swapaxes(a.im, -1, -2))

    def step(state):
        if warm_basis:
            y, z, m_dual, n_dual, mu, v_basis = state
        else:
            y, z, m_dual, n_dual, mu = state
            v_basis = None
        inv_mu = 1.0 / mu
        # X-update: U (A^H (Y - M/mu) + (Z - N/mu))
        t = Pair(y.re - m_dual.re * inv_mu, y.im - m_dual.im * inv_mu)
        rhs = add(matmul(ah, t), Pair(z.re - n_dual.re * inv_mu,
                                      z.im - n_dual.im * inv_mu))
        x = matmul(u_mat, rhs)
        ax = matmul(a, x)
        y_new = magnitude_prox_rows(ax, b, m_dual, mu)
        z_in = Pair(x.re + n_dual.re * inv_mu, x.im + n_dual.im * inv_mu)
        if warm_basis:
            z_new, v_new = spectral_profile_prox_pair(
                z_in, nt, nr, ladder, sweeps=sweeps, v0=v_basis,
                return_basis=True)
        else:
            z_new = spectral_profile_prox_pair(z_in, nt, nr, ladder,
                                               sweeps=sweeps)
        m_new = Pair(m_dual.re + mu * (ax.re - y_new.re),
                     m_dual.im + mu * (ax.im - y_new.im))
        n_new = Pair(n_dual.re + mu * (x.re - z_new.re),
                     n_dual.im + mu * (x.im - z_new.im))
        if warm_basis:
            return (y_new, z_new, m_new, n_new, mu * 1.03, v_new)
        return (y_new, z_new, m_new, n_new, mu * 1.03)

    return step
