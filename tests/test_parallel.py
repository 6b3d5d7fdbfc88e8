"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY §4: multi-host tests via xla_force_host_platform_device_count)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from twoace.config import AdmmConfig, ArrayConfig, ChannelConfig
from twoace.models import generate_channel
from twoace.parallel import make_mesh, problem_sharding, solve_lowrank_sharded
from twoace.utils.metrics import nmse_h_projection


def _problem(key, cfg, batch, m):
    ch = generate_channel(key, cfg, ChannelConfig(n_paths=2, rician_k=0),
                          batch=batch, dtype=jnp.complex128)
    n = cfg.n
    phases = jax.random.randint(jax.random.fold_in(key, 9),
                                (batch, m, n), 0, 4)
    a = jnp.exp(1j * phases * (np.pi / 2)) / np.sqrt(n)
    b = jnp.abs(jnp.einsum("umn,un->um", a, ch.vec_h))
    return a, b, ch


def test_mesh_shapes():
    mesh = make_mesh(rows=2)
    assert mesh.devices.shape == (4, 2)
    mesh = make_mesh(batch=8, rows=1)
    assert mesh.devices.shape == (8, 1)


def test_sharded_solver_recovers():
    """4-way batch x 2-way row sharding must recover channels like the
    single-device solver does."""
    key = jax.random.PRNGKey(0)
    cfg = ArrayConfig(nt=4, nr=4)
    mesh = make_mesh(batch=4, rows=2)
    batch, m = 4, 64
    a, b, ch = _problem(key, cfg, batch, m)
    a_sh, b_sh = problem_sharding(mesh)
    a = jax.device_put(a, a_sh)
    b = jax.device_put(b, b_sh)
    x = solve_lowrank_sharded(mesh, a, b, cfg.nt, cfg.nr,
                              AdmmConfig(maxiter=300))
    nmse = np.asarray(nmse_h_projection(x, ch.vec_h))
    assert x.shape == (batch, cfg.n)
    assert np.all(np.isfinite(nmse))
    # noiseless, m = 4n: expect strong recovery on most instances
    assert np.median(nmse) < 0.1, nmse


def test_sharded_matches_row_replicated():
    """Row sharding is an implementation detail: 1-row-shard and 2-row-shard
    meshes must agree to numerical precision."""
    key = jax.random.PRNGKey(1)
    cfg = ArrayConfig(nt=4, nr=4)
    batch, m = 2, 48
    a, b, _ = _problem(key, cfg, batch, m)

    mesh1 = make_mesh(batch=2, rows=1)
    mesh2 = make_mesh(batch=2, rows=2)
    cfg_a = AdmmConfig(maxiter=120)
    x1 = np.asarray(solve_lowrank_sharded(mesh1, a, b, cfg.nt, cfg.nr, cfg_a))
    x2 = np.asarray(solve_lowrank_sharded(mesh2, a, b, cfg.nt, cfg.nr, cfg_a))
    # identical math, different partitioning: tight agreement
    err = np.linalg.norm(x1 - x2) / np.linalg.norm(x1)
    assert err < 1e-6, err


def test_sharded_pair_solver_recovers():
    """Pair-form sharded solver (the multi-device production path) recovers
    channels on the same (batch x rows) mesh."""
    from twoace.ops.cplx import Pair
    from twoace.parallel import solve_lowrank_sharded_pair

    key = jax.random.PRNGKey(3)
    cfg = ArrayConfig(nt=4, nr=4)
    mesh = make_mesh(batch=4, rows=2)
    batch, m = 4, 64
    a, b, ch = _problem(key, cfg, batch, m)
    ap = Pair(jnp.real(a).astype(jnp.float32),
              jnp.imag(a).astype(jnp.float32))
    a_sh, b_sh = problem_sharding(mesh)
    ap = Pair(jax.device_put(ap.re, a_sh), jax.device_put(ap.im, a_sh))
    bf = jax.device_put(b.astype(jnp.float32), b_sh)
    x = solve_lowrank_sharded_pair(mesh, ap, bf, cfg.nt, cfg.nr,
                                   AdmmConfig(maxiter=300))
    xc = jnp.asarray(np.asarray(x.re) + 1j * np.asarray(x.im))
    nmse = np.asarray(nmse_h_projection(xc, ch.vec_h))
    assert x.re.shape == (batch, cfg.n)
    assert np.all(np.isfinite(nmse))
    assert np.median(nmse) < 0.1, nmse


def test_sharded_pair_matches_complex_sharded():
    """Pair and complex sharded solvers agree on recovery quality."""
    from twoace.ops.cplx import Pair
    from twoace.parallel import solve_lowrank_sharded_pair

    key = jax.random.PRNGKey(4)
    cfg = ArrayConfig(nt=4, nr=4)
    mesh = make_mesh(batch=2, rows=1)
    batch, m = 2, 64
    a, b, ch = _problem(key, cfg, batch, m)
    a_sh, b_sh = problem_sharding(mesh)
    x_c = solve_lowrank_sharded(mesh, jax.device_put(a, a_sh),
                                jax.device_put(b, b_sh), cfg.nt, cfg.nr,
                                AdmmConfig(maxiter=250))
    ap = Pair(jnp.real(a).astype(jnp.float32),
              jnp.imag(a).astype(jnp.float32))
    ap = Pair(jax.device_put(ap.re, a_sh), jax.device_put(ap.im, a_sh))
    x_p = solve_lowrank_sharded_pair(mesh, ap,
                                     jax.device_put(b.astype(jnp.float32),
                                                    b_sh),
                                     cfg.nt, cfg.nr, AdmmConfig(maxiter=250))
    xpc = jnp.asarray(np.asarray(x_p.re) + 1j * np.asarray(x_p.im))
    n_c = np.asarray(nmse_h_projection(x_c, ch.vec_h))
    n_p = np.asarray(nmse_h_projection(xpc, ch.vec_h))
    # same algorithm, different arithmetic path: NMSEs in the same class
    assert np.all(np.isfinite(n_p))
    for u in range(batch):
        db_c = 10 * np.log10(max(n_c[u], 1e-12))
        db_p = 10 * np.log10(max(n_p[u], 1e-12))
        assert db_p < max(db_c + 3.0, -20.0), (db_c, db_p)


def test_sharded_pair_nuclear_runs():
    """Nuclear prox variant of the pair sharded solver stays finite."""
    from twoace.ops.cplx import Pair
    from twoace.parallel import solve_lowrank_sharded_pair

    key = jax.random.PRNGKey(5)
    cfg = ArrayConfig(nt=4, nr=4)
    mesh = make_mesh(batch=4, rows=2)
    batch, m = 4, 64
    a, b, ch = _problem(key, cfg, batch, m)
    a_sh, b_sh = problem_sharding(mesh)
    ap = Pair(jax.device_put(jnp.real(a).astype(jnp.float32), a_sh),
              jax.device_put(jnp.imag(a).astype(jnp.float32), a_sh))
    bf = jax.device_put(b.astype(jnp.float32), b_sh)
    x = solve_lowrank_sharded_pair(mesh, ap, bf, cfg.nt, cfg.nr,
                                   AdmmConfig(maxiter=150),
                                   prox_kind="nuclear")
    assert np.isfinite(np.asarray(x.re)).all()
    assert np.isfinite(np.asarray(x.im)).all()


def test_sharded_multi_scaffold_matches_single_chip_quality():
    """VERDICT r03 #5: a row-sharded deployment must run the SAME algorithm
    as the single-chip production solver.  solve_lowrank_multi_sharded_pair
    (CV restarts + quality gate + rank-1 retry + rollback, row-sharded
    inner solves) is compared against solve_lowrank_multi_pair on
    IDENTICAL instances — not rows=2 vs rows=1 self-consistency."""
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair
    from twoace.parallel.sharded_pair import (
        solve_lowrank_multi_sharded_pair)

    key = jax.random.PRNGKey(3)
    cfg = ArrayConfig(nt=4, nr=4)
    batch, m = 4, 64
    a, b, ch = _problem(key, cfg, batch, m)
    ap = Pair(jnp.real(a).astype(jnp.float32),
              jnp.imag(a).astype(jnp.float32))
    bf = jnp.asarray(b, jnp.float32)
    mesh = make_mesh(batch=4, rows=2)
    a_sh, b_sh = problem_sharding(mesh)
    keys = jax.random.split(key, batch)

    admm = AdmmConfig(maxiter=200, n_restarts=2)
    xs, qs = solve_lowrank_multi_sharded_pair(
        mesh, keys,
        Pair(jax.device_put(ap.re, a_sh), jax.device_put(ap.im, a_sh)),
        jax.device_put(bf, b_sh), cfg.nt, cfg.nr, admm)
    x_sh = np.asarray(xs.re) + 1j * np.asarray(xs.im)
    qs = np.asarray(qs)

    nmse_sh = np.asarray(nmse_h_projection(jnp.asarray(x_sh), ch.vec_h))
    for u in range(batch):
        res = solve_lowrank_multi_pair(keys[u],
                                       Pair(ap.re[u], ap.im[u]), bf[u],
                                       cfg.nt, cfg.nr, admm)
        x1 = np.asarray(res.x.re) + 1j * np.asarray(res.x.im)
        nmse_1 = float(nmse_h_projection(jnp.asarray(x1)[None],
                                         ch.vec_h[u:u + 1])[0])
        # same algorithm, different reduction/eig paths: require the same
        # RECOVERY QUALITY class, not bitwise iterates
        assert abs(qs[u] - float(res.quality)) < 0.05, u
        db_sh = 10 * np.log10(max(nmse_sh[u], 1e-30))
        db_1 = 10 * np.log10(max(nmse_1, 1e-30))
        # both deep-converged (f32 floor) or within a few dB of each other
        assert db_sh < -40 or abs(db_sh - db_1) < 6.0, (u, db_sh, db_1)
