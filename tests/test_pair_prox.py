"""The pair-form Y- and Z-steps of the production ADMM body against the
float64 NumPy reference (tests/reference_numpy.py).

These are the plain-JAX stages XLA fuses on every backend: the magnitude
prox with the M-dual update, and the warm perturbative Z-prox chain
(Gram -> first-order eigenbasis update -> constraint ladder -> delta).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import reference_numpy as ref
from twoace.ops.cplx import (Pair, _panel_spectral_prox_c,
                             magnitude_prox_cols, panel_gram_basis_pair)
from twoace.ops.pair_solver import _panel_maps, magnitude_prox_cols_elem
from twoace.ops.prox import profile_ladder


def _pair(x):
    return Pair(jnp.asarray(x.real, jnp.float32),
                jnp.asarray(x.imag, jnp.float32))


def _c(p):
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


def _crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


# ------------------------------------------------------- prox + M-dual

@pytest.mark.parametrize("m, r, zero_rows, pad_rows", [
    (192, 24, 0, 0),      # plain
    (100, 8, 0, 0),       # ragged m
    (37, 5, 0, 0),        # odd, tiny
    (64, 6, 5, 0),        # zero rows: the constant-direction branch
    (64, 6, 0, 7),        # b == 0 padding rows: inactive, prox to 0
    (101, 20, 3, 4),      # all of it at the production width r = 20
])
def test_prox_dual_matches_reference(m, r, zero_rows, pad_rows):
    """y = ArgMinY(AX, b, M, mu) by rows and M + mu (AX - y), in the
    transposed (r, m) layout, against the float64 reference in (m, r)."""
    rng = np.random.default_rng(m * 31 + r)
    ax = _crandn(rng, m, r)
    md = _crandn(rng, m, r)
    b = rng.uniform(0.5, 2.0, m)
    mu = 0.31
    if zero_rows:
        ax[:zero_rows] = 0.0
        md[:zero_rows] = 0.0
    if pad_rows:
        b[m - pad_rows:] = 0.0

    y_ref = ref.magnitude_prox(ax, b, md, mu, True)
    y_ref[b == 0] = 0.0                  # padding contract (A2only.m:130-139)
    m_ref = md + mu * (ax - y_ref)

    ax_t, md_t = _pair(ax.T), _pair(md.T)
    mu32 = jnp.float32(mu)
    y = magnitude_prox_cols(ax_t, jnp.asarray(b, jnp.float32), md_t, mu32)
    m_new = Pair(md_t.re + mu32 * (ax_t.re - y.re),
                 md_t.im + mu32 * (ax_t.im - y.im))
    np.testing.assert_allclose(_c(y).T, y_ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_c(m_new).T, m_ref, atol=5e-5, rtol=2e-5)
    if zero_rows:
        np.testing.assert_allclose(np.abs(_c(y).T[:zero_rows]),
                                   np.abs(y_ref[:zero_rows]), atol=1e-6)
    if pad_rows:
        assert np.all(_c(y).T[m - pad_rows:] == 0)


@pytest.mark.parametrize("m, r", [(64, 6), (37, 20)])
def test_elementwise_prox_matches_reference(m, r):
    """The per-column (scale_by_row=False) prox of the second pass."""
    rng = np.random.default_rng(m + r)
    ax, md = _crandn(rng, m, r), _crandn(rng, m, r)
    b = rng.uniform(0.5, 2.0, m)
    y_ref = ref.magnitude_prox(ax, b, md, 0.7, False)
    y = magnitude_prox_cols_elem(_pair(ax.T), jnp.asarray(b, jnp.float32),
                                 _pair(md.T), jnp.float32(0.7))
    np.testing.assert_allclose(_c(y).T, y_ref, atol=2e-5, rtol=2e-5)


# ------------------------------------------------- warm Z-prox chain

@pytest.mark.parametrize("nr", [4, 8, 16])
def test_warm_zprox_chain_matches_exact_eigh(nr):
    """One warm step of the production Z-prox: the eigenbasis carried from
    the previous iterate is refined by the first-order update, and the
    result matches the reference prox built on an exact ``eigh``."""
    nt, r = nr, 6
    n = nt * nr
    m = 2 * n                    # under-determined: the multi-level ladder
    ladder = profile_ladder(nt, nr, m, n, False)
    lad_ref = ref.ladder(nt, nr, m, n, False)
    assert [tuple(map(float, lv)) for lv in ladder] == \
        [tuple(map(float, lv)) for lv in lad_ref]

    rng = np.random.default_rng(nr)
    # a low-rank-dominated Z (what the iterates look like) plus a small
    # move since the previous iteration
    base = (_crandn(rng, n, 2) @ _crandn(rng, 2, r)
            + 0.05 * _crandn(rng, n, r))
    z_prev = base
    z = base + 1e-3 * _crandn(rng, n, r)

    to_panel, from_panel = _panel_maps(nt, nr, r)

    def panel(zz):
        zt = _pair(zz.T)
        return Pair(to_panel(zt.re), to_panel(zt.im))

    v0 = panel_gram_basis_pair(panel(z_prev))[1]
    e_new, v = _panel_spectral_prox_c(panel(z), nr, ladder, v0)
    got = (np.asarray(from_panel(e_new.re), np.float64)
           + 1j * np.asarray(from_panel(e_new.im), np.float64)).T

    want = ref.profile_prox(z.copy(), nt, nr, lad_ref)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-4, err
    # the refined basis stays unitary
    vc = _c(v)
    np.testing.assert_allclose(vc.conj().T @ vc, np.eye(nr), atol=1e-4)
