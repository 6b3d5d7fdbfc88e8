"""Float64 NumPy reference implementation of the 2ACE A2 solver.

Written from the algorithm specification (SURVEY §2.1 S2-S5 /
ref: main/src/my_recovery_algorithms/ADMM_v2/inferLowRankV4_multi.m) as an
independent oracle for parity testing the JAX implementation — converged
NMSE of the two stacks must agree (SURVEY §4: "golden-value parity tests
against ... the MATLAB algorithm re-implemented in float64 NumPy").

Deliberately simple/direct NumPy; no JAX.
"""

from __future__ import annotations

import numpy as np


def magnitude_prox(ax, b, m_dual, mu, by_row):
    y = ax + m_dual / mu
    if by_row:
        d = np.linalg.norm(y, axis=1, keepdims=True)
        y = np.where(d == 0, 1.0 / np.sqrt(y.shape[1]), y)
        d = np.where(d == 0, 1.0, d)
        return y * ((b[:, None] / d + mu) / (1 + mu))
    d = np.abs(y)
    y = np.where(d == 0, 1.0, y)
    d = np.where(d == 0, 1.0, d)
    return y * ((b[:, None] / d + mu) / (1 + mu))


def set_row_magnitudes(y, b, by_row):
    if by_row:
        d = np.linalg.norm(y, axis=1, keepdims=True)
        y = np.where(d == 0, 1.0 / np.sqrt(y.shape[1]), y)
        d = np.where(d == 0, 1.0, d)
        return y * (b[:, None] / d)
    d = np.abs(y)
    y = np.where(d == 0, 1.0, y)
    d = np.where(d == 0, 1.0, d)
    return y * (b[:, None] / d)


def ladder(nt, nr, m, n, rank_one):
    sz = min(nt, nr)
    r0 = int(np.ceil(np.sqrt(sz) * 0.5))
    r1 = int(np.ceil(np.sqrt(sz) * 0.7))
    r2 = int(np.ceil(np.sqrt(sz)))
    r3 = min(sz, int(np.ceil(np.sqrt(sz) * 2.0)))
    if rank_one:
        return [(1, 0.95)]
    if m >= 3 * n:
        return [(r3, 0.995)]
    if r1 <= 2:
        return [(r2, 0.95)]
    if r0 <= 2:
        return [(r1, 0.9), (r2, 0.95), (r3, 0.995)]
    return [(r0, 0.8), (r1, 0.9), (r2, 0.95), (r3, 0.995)]


def profile_prox(z, nt, nr, lad):
    n, r = z.shape
    # columns -> channel panel, rx index fastest in the vec
    e = np.concatenate([z[:, c].reshape(nt, nr).T for c in range(r)], axis=1)
    g = e @ e.conj().T
    w, u = np.linalg.eigh((g + g.conj().T) / 2)
    w = np.maximum(w[::-1], 0.0)
    u = u[:, ::-1]
    scale = np.ones_like(w)
    for rk, f in lad:
        v = w.sum()
        vr = w[:rk].sum()
        if vr < v * f:
            s = min(1.0, vr / max(v - vr, 1e-300) * (1 / f - 1))
            w[rk:] *= s
            scale[rk:] *= s
    e2 = e + u @ ((np.sqrt(scale) - 1)[:, None] * (u.conj().T @ e))
    out = np.zeros_like(z)
    for c in range(r):
        out[:, c] = e2[:, c * nt:(c + 1) * nt].T.reshape(-1)
    return out


def spectral_init(a, b, r):
    norms = np.linalg.norm(a, axis=1)
    scale = np.where(norms > 0, b / np.maximum(norms, 1e-300), 1.0)
    a_s = a * scale[:, None]
    g = a_s.conj().T @ a_s
    w, v = np.linalg.eigh((g + g.conj().T) / 2)
    w = np.maximum(w[::-1], 0.0)[:r]
    v = v[:, ::-1][:, :r]
    return v * np.sqrt(w)[None, :]


def infer_admm(a, b, x0, by_row, rank_one, nt, nr, mu0=1e-3, rho=1.03,
               tol_rel=1e-4, tol_abs=1e-8, maxiter=500):
    m, n = a.shape
    r = x0.shape[1]
    lad = ladder(nt, nr, m, n, rank_one)
    u_mat = np.linalg.inv(a.conj().T @ a + np.eye(n))

    x = x0.copy()
    ax = a @ x
    if by_row:
        x = x * (np.linalg.norm(b) / np.linalg.norm(ax))
    else:
        x = x * (np.linalg.norm(b) / np.linalg.norm(ax, axis=0))[None, :]
    ax = a @ x
    y = set_row_magnitudes(ax, b, by_row)
    z = profile_prox(x, nt, nr, lad)
    aty = a.conj().T @ y
    m_dual = np.zeros((m, r), complex)
    n_dual = np.zeros((n, r), complex)

    mu, last, opt = mu0, np.inf, np.inf
    opt_x, opt_y = x, y
    for _ in range(maxiter):
        y0, z0, aty0 = y, z, aty
        x = u_mat @ (a.conj().T @ (y - m_dual / mu) + (z - n_dual / mu))
        ax = a @ x
        y = magnitude_prox(ax, b, m_dual, mu, by_row)
        aty = a.conj().T @ y
        z = profile_prox(x + n_dual / mu, nt, nr, lad)
        j_m, j_n = ax - y, x - z
        m_dual = m_dual + mu * j_m
        n_dual = n_dual + mu * j_n

        if by_row:
            obj = np.linalg.norm(np.sqrt((np.abs(ax) ** 2).sum(1)) - b)
            if obj < opt:
                opt, opt_x, opt_y = obj, x, y
        else:
            objs = np.linalg.norm(np.abs(ax) - b[:, None], axis=0)
            j = int(np.argmin(objs))
            if objs[j] < opt:
                opt, opt_x, opt_y = objs[j], x[:, j], y[:, j]

        rp = np.sqrt(np.linalg.norm(j_m) ** 2 + np.linalg.norm(j_n) ** 2)
        rd = mu * np.sqrt(np.linalg.norm(aty - aty0) ** 2
                          + np.linalg.norm(z - z0) ** 2)
        rc = np.sqrt(rp ** 2 + np.linalg.norm(y - y0) ** 2
                     + np.linalg.norm(z - z0) ** 2)
        nax, ny = np.linalg.norm(ax), np.linalg.norm(y)
        nx, nz = np.linalg.norm(x), np.linalg.norm(z)
        tp = tol_abs * np.sqrt((m + n) * r) + tol_rel * np.sqrt(
            max(nax, ny) ** 2 + max(nx, nz) ** 2)
        td = tol_abs * np.sqrt(2 * n * r) + tol_rel * np.sqrt(
            np.linalg.norm(aty) ** 2 + nz ** 2)
        tc = tol_abs * np.sqrt(2 * (m + n) * r) + tol_rel * np.sqrt(
            max(nax, ny) ** 2 + max(nx, nz) ** 2 + ny ** 2 + nz ** 2)
        if (rp < tp and rd < td) or rc < tc:
            break
        if rc > last * 0.9:
            mu *= rho
        last = rc
    return opt_x, opt_y


def solve_a2(rng, a, b, nt, nr, r=20, cc_frac=0.95, n_restarts=3,
             maxiter=500):
    """inferLowRankV4_multi scaffold: normalize, restarts with CV splits,
    rank-1 fallback, refinement with rollback, rescale."""
    m, n = a.shape
    r = min(r, m, n)
    a_norm = np.linalg.norm(a) / np.sqrt(m)
    b_norm = np.linalg.norm(b)
    a = a / a_norm
    b = b / b_norm

    best = None
    for _ in range(n_restarts):
        perm = rng.permutation(m)
        k = int(np.floor(m * cc_frac))
        tr, te = perm[:k], perm[k:]
        xs = spectral_init(a[tr], b[tr], r)

        def run(rank_one):
            x, y = infer_admm(a[tr], b[tr], xs, True, rank_one, nt, nr,
                              maxiter=maxiter)
            w, v = np.linalg.eigh(x.conj().T @ x)
            x = x @ v
            x, y = infer_admm(a[tr], b[tr], x, False, rank_one, nt, nr,
                              maxiter=maxiter)
            q = 1 - np.linalg.norm(np.abs(a[te] @ x) - b[te]) \
                / np.linalg.norm(b[te])
            return x, y, q

        x, y, q = run(False)
        rank_one = False
        if q < 0.6:
            x, y, q = run(True)
            rank_one = True
        if best is None or q > best[2]:
            best = (x, y, q, rank_one)

    x_max, _, q_max, rank_one = best
    xr, yr = infer_admm(a, b, x_max[:, None], True, rank_one, nt, nr,
                        maxiter=maxiter)
    xr = xr[:, 0]
    if q_max > 0.6:
        sim = abs(np.vdot(x_max, xr)) / (np.linalg.norm(x_max)
                                         * np.linalg.norm(xr))
        if sim < 0.6:
            xr = x_max
    return xr * (b_norm / a_norm)
