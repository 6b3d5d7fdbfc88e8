#!/usr/bin/env python
"""Smoke run of the 2ACE recovery path on one GPU.

Drives the system's main path once, through the entry points a user calls,
at the full widths the repo supports, and checks what comes out:

  device      the GPU JAX sees, and the card's nvidia-smi name and power
              limit (printed beside every later number)
  batch       ``solve_lowrank_multi_pair_batch`` on the bench workload:
              16x16 (n=256), m=1024, r=20, batch 64 of 2-path channels
              through one shared 2-bit codebook; once with the library
              defaults (cold) and once with the bench settings (warm-80,
              pass caps 120/160)
  full-URA    the same solver at 32x32 (n=1024), m=4096, batch 8, defaults
  single      ``solve_lowrank_multi_pair`` (the tracking path) at 16x16
  trajectory  50 inner-ADMM iterations of ``infer_admm_pair`` at 16x16
              with the convergence exit disabled, against the float64
              NumPy reference (tests/reference_numpy.py)
  testbed     ``TestbedRunner`` + ``SyntheticProvider`` at the reference
              campaign size (64 rounds x 62 sectors, 16x16), then
              ``estimate("random", "a2only")`` over the reference M grid
              (4 ... 1024); the same campaign through the CLI's
              ``testbed`` subcommand (``twoace.cli.main``); and the top
              budget's recovery from the same data on this device and on
              the CPU, in this process

Every check states its precision and tolerance.  Any failed check or phase
exits non-zero; on success the last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--mesh4`` runs only the 4-GPU phase: ``solve_lowrank_multi_sharded_pair``
on a (batch 1 x rows 4) and a (batch 2 x rows 2) mesh at 32x32/m=4096,
compared with ``solve_lowrank_multi_pair`` on one card.

Usage::

    python chip_smoke.py [--out results.json]
    python chip_smoke.py --mesh4 [--out results.json]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: accuracy against truth: the parity band of config.AdmmConfig's
#: accuracy contract (median NMSE) and the quality gate every instance meets
NMSE_LIMIT_DB = -60.0
MIN_QUALITY = 0.99
#: inner-ADMM trajectory against the float64 reference: relative error of
#: x after TRAJ_ITERS iterations at matmul precision "float32" (HIGHEST)
TRAJ_ITERS = 50
TRAJ_TOL_F32 = 1e-4
#: testbed: the bound of tests/test_pipeline.py's campaign test (linear
#: NMSE of the best-M estimate) and BASELINE.md's +-0.5 dB parity bound
#: between this device and the CPU
TESTBED_NMSE_BOUND = 0.3
TESTBED_PARITY_DB = 0.5
#: the CLI runs the library's campaign with the same compiled solver
TESTBED_CLI_DB = 0.01


class CheckFailed(RuntimeError):
    """A comparison fell outside its stated tolerance."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def ok_line(device: dict) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


class Report:
    """Prints one line per result, each beside the card's nvidia-smi line,
    and keeps every result for ``--out``."""

    def __init__(self, card: str):
        self.card = card
        self.results: dict = {}

    def line(self, phase: str, **fields) -> None:
        self.results[phase] = fields
        body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{phase}] {body} | {self.card}", flush=True)


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    return v


# ---------------------------------------------------------------- problems

def build_problem(nt: int, nr: int, m: int, batch: int, seed: int):
    """``batch`` 2-path channels measured through ONE shared 2-bit random
    codebook (the bench workload).  Returns ``(a Pair (m, n), b (batch, m)
    float32, x_true (batch, n) complex128)``."""
    import jax.numpy as jnp
    from twoace.ops.cplx import Pair

    n = nt * nr
    rng = np.random.default_rng(seed)
    a = np.exp(1j * rng.integers(0, 4, (m, n)) * (np.pi / 2)) / np.sqrt(n)

    def steer(k, ang):
        return np.exp(1j * np.pi * np.arange(k) * np.sin(ang)) / np.sqrt(k)

    xs = []
    for _ in range(batch):
        angs = rng.uniform(-1.2, 1.2, 4)
        h = sum((rng.normal() + 1j * rng.normal())
                * np.outer(steer(nr, angs[2 * i]),
                           steer(nt, angs[2 * i + 1]).conj())
                for i in range(2))
        xs.append(h.T.reshape(-1))
    x_true = np.stack(xs)
    b = np.abs(x_true @ a.T)
    ap = Pair(jnp.asarray(a.real, jnp.float32),
              jnp.asarray(a.imag, jnp.float32))
    return ap, jnp.asarray(b, jnp.float32), x_true


def nmse_db(x_est, x_true):
    """Per-row NMSE in dB after the best global phase/scale alignment."""
    x_est = np.atleast_2d(x_est)
    x_true = np.atleast_2d(x_true)
    out = []
    for e, t in zip(x_est, x_true):
        c = np.vdot(e, t) / max(np.vdot(e, e).real, 1e-300)
        err = np.linalg.norm(t - c * e) ** 2 / np.linalg.norm(t) ** 2
        out.append(10.0 * np.log10(max(err, 1e-30)))
    return np.asarray(out)


def _complex(p):
    return np.asarray(p.re, np.float64) + 1j * np.asarray(p.im, np.float64)


# ------------------------------------------------------------------ phases

def batch_phase(ap, b, x_true, nt: int, nr: int, cfg, reps: int = 1):
    """Run the batch solver ``1 + reps`` times: the first call (trace,
    compile and run) gives ``compile_s``, the others the timed rate.
    Returns the phase's numbers."""
    import jax
    from twoace.ops.pair_solver import solve_lowrank_multi_pair_batch

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    res = jax.block_until_ready(
        solve_lowrank_multi_pair_batch(key, ap, b, nt, nr, cfg))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        res = jax.block_until_ready(
            solve_lowrank_multi_pair_batch(key, ap, b, nt, nr, cfg))
    dt = (time.perf_counter() - t0) / reps
    nm = nmse_db(_complex(res.x), x_true)
    batch = b.shape[0]
    return {
        "batch": batch,
        "recoveries_per_s": batch / dt,
        "seconds_per_call": dt,
        "compile_s": first_s - dt,
        "iters_per_instance": float(np.mean(np.asarray(res.iters))),
        "median_nmse_db": float(np.median(nm)),
        "worst_nmse_db": float(np.max(nm)),
        "min_quality": float(np.min(np.asarray(res.quality))),
    }


def check_accuracy(name: str, stats: dict) -> None:
    """(b) accuracy against truth, float32 solver vs exact channels."""
    check(stats["median_nmse_db"] <= NMSE_LIMIT_DB,
          f"{name}: median NMSE {stats['median_nmse_db']:.2f} dB above "
          f"{NMSE_LIMIT_DB} dB")
    check(stats["min_quality"] >= MIN_QUALITY,
          f"{name}: min quality {stats['min_quality']:.4f} < {MIN_QUALITY}")


def single_phase(ap, b_one, x_one, nt: int, nr: int, cfg, reps: int = 5):
    """``solve_lowrank_multi_pair`` on one instance; ms per solve from the
    host clock around calls that end in ``block_until_ready``."""
    import jax
    from twoace.ops.pair_solver import solve_lowrank_multi_pair

    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    res = jax.block_until_ready(
        solve_lowrank_multi_pair(key, ap, b_one, nt, nr, cfg))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(reps):
        res = jax.block_until_ready(solve_lowrank_multi_pair(
            jax.random.fold_in(key, i), ap, b_one, nt, nr, cfg))
    ms = (time.perf_counter() - t0) / reps * 1e3
    return {"ms_per_solve": ms, "compile_s": first_s - ms / 1e3,
            "iters": int(res.iters), "quality": float(res.quality),
            "nmse_db": float(nmse_db(_complex(res.x), x_one)[0])}


def trajectory_deviation(nt: int, nr: int, m: int, r: int, iters: int,
                         precision: str, seed: int = 5) -> float:
    """(a) Relative error ||x - x_ref|| / ||x_ref|| of ``iters`` inner-ADMM
    iterations (first pass, scale_by_row) of ``infer_admm_pair`` under
    matmul ``precision`` against ``reference_numpy.infer_admm`` in float64,
    both with the convergence exit disabled (tolerances 0) and from the
    same normalized problem and spectral start.  The Z-prox runs exact
    8-sweep Jacobi eigendecompositions, so the deviation measures the
    arithmetic, not the production path's perturbative eigenbasis."""
    import jax
    import jax.numpy as jnp
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import infer_admm_pair
    from twoace.ops.prox import profile_ladder

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import reference_numpy as ref

    n = nt * nr
    ap, b, x_true = build_problem(nt, nr, m, 1, seed)
    a = _complex(ap)
    bb = np.abs(a @ x_true[0])
    a = a / (np.linalg.norm(a) / np.sqrt(m))
    bb = bb / np.linalg.norm(bb)
    x0 = ref.spectral_init(a, bb, r)
    x_ref, _ = ref.infer_admm(a, bb, x0, True, False, nt, nr, tol_rel=0.0,
                              tol_abs=0.0, maxiter=iters)

    def pair(z):
        return Pair(jnp.asarray(z.real, jnp.float32),
                    jnp.asarray(z.imag, jnp.float32))

    ladder = profile_ladder(nt, nr, m, n, False)

    @jax.jit
    def run(a_p, b_j, x0_t):
        with jax.default_matmul_precision(precision):
            x, _, _, _ = infer_admm_pair(
                a_p, b_j, x0_t, scale_by_row=True, nt=nt, nr=nr,
                ladder=ladder, tol_rel=0.0, tol_abs=0.0, maxiter=iters,
                eig_mode="jacobi", sweeps=8)
        return x

    x = run(pair(a), jnp.asarray(bb, jnp.float32), pair(x0.T))
    x = _complex(x).T
    return float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))


def testbed_campaign(nt: int, nr: int, rounds: int, sectors: int,
                     seed: int = 0):
    """Synthetic testbed campaign + ``estimate("random", "a2only")`` over
    the reference M grid on the default device.  Returns ``(numbers,
    runner, channel)``; the numbers carry the top budget's NMSE."""
    import jax
    import twoace as t2
    from twoace.models import generate_channel
    from twoace.pipeline import CampaignConfig, TestbedConfig, TestbedRunner
    from twoace.sensing.provider import SyntheticProvider

    cfg = t2.ArrayConfig(nt=nt, nr=nr)
    key = jax.random.PRNGKey(seed)
    ch = generate_channel(key, cfg, t2.ChannelConfig(n_paths=2, rician_k=0),
                          batch=1)
    prov = SyntheticProvider(vec_h=ch.vec_h[0] * 3e-4, noise_dbm_std=0.0)
    runner = TestbedRunner(TestbedConfig(array=cfg, n_random_rounds=rounds,
                                         sectors_per_round=sectors),
                           prov, key=key)
    t0 = time.perf_counter()
    runner.run_random_campaign()
    out = runner.estimate("random", "a2only",
                          cc=CampaignConfig(array=cfg, n_paths=2))
    seconds = time.perf_counter() - t0
    h = out.h_amp[-1, 0] * np.exp(1j * out.h_angle[-1, 0])
    nmse = _h_nmse(h, ch)
    return ({"probes": rounds * sectors, "m_grid": list(out.m_grid),
             "nmse": nmse,
             "nmse_db": float(10.0 * np.log10(max(nmse, 1e-30))),
             "seconds": seconds}, runner, ch)


def _h_nmse(h, ch) -> float:
    import jax.numpy as jnp
    from twoace.utils.metrics import nmse_h_projection

    return float(nmse_h_projection(jnp.asarray(h)[None],
                                   ch.vec_h * 3e-4)[0])


def testbed_on_device(runner, ch, m: int, device=None) -> float:
    """The campaign's A2 recovery at the single probe budget ``m`` on
    ``device`` (None: the default device, where it reuses the campaign
    estimate's compiled solver), from the campaign's own measurements
    through ``recover_campaign``; returns its NMSE in dB."""
    import jax
    import jax.numpy as jnp
    from twoace.config import MethodFlags
    from twoace.pipeline import CampaignConfig
    from twoace.pipeline.recovery import recover_campaign

    data = runner.results["random"]
    cfg = runner.cfg.array
    place = (contextlib.nullcontext() if device is None
             else jax.default_device(device))
    with place:
        out = recover_campaign(jnp.asarray(data["rows"]),
                               jnp.asarray(data["rss_dbm"]),
                               MethodFlags(admm_lowrank_v4=True),
                               CampaignConfig(array=cfg, n_paths=2),
                               m_grid=(m,))
        h = out.h_amp[0, 0] * np.exp(1j * out.h_angle[0, 0])
        return float(10.0 * np.log10(max(_h_nmse(h, ch), 1e-30)))


def cli_testbed(argv) -> dict:
    """``twoace.cli.main(argv)`` in this process; returns its summary."""
    from twoace.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def check_mesh4_devices(devices) -> None:
    """``--mesh4`` needs exactly four GPUs."""
    if len(devices) != 4 or any(d.platform != "gpu" for d in devices):
        raise CheckFailed(
            f"--mesh4 needs exactly 4 GPUs, found {len(devices)} device(s) "
            f"on {sorted({d.platform for d in devices})}")


def mesh4_phase(report: Report, nt: int = 32, m: int = 4096,
                batch: int = 2) -> None:
    """Row- and batch-sharded production scaffold on 4 cards against the
    one-card solver on the same instances."""
    import jax
    import jax.numpy as jnp
    from twoace.config import AdmmConfig
    from twoace.ops.cplx import Pair
    from twoace.ops.pair_solver import solve_lowrank_multi_pair
    from twoace.parallel import make_mesh, problem_sharding
    from twoace.parallel.sharded_pair import solve_lowrank_multi_sharded_pair

    cfg = AdmmConfig()
    ap, b, x_true = build_problem(nt, nt, m, batch, seed=11)
    keys = jax.random.split(jax.random.PRNGKey(7), batch)

    one = jax.devices()[0]
    t0 = time.perf_counter()
    xs, qs = [], []
    for i in range(batch):
        res = jax.block_until_ready(solve_lowrank_multi_pair(
            jax.device_put(keys[i], one), jax.device_put(ap, one),
            jax.device_put(b[i], one), nt, nt, cfg))
        xs.append(_complex(res.x))
        qs.append(float(res.quality))
    nm1 = nmse_db(np.stack(xs), x_true)
    tol = f"median<={NMSE_LIMIT_DB}dB,quality>={MIN_QUALITY}"
    report.line("mesh4-one-card", seconds=time.perf_counter() - t0,
                median_nmse_db=float(np.median(nm1)),
                worst_nmse_db=float(np.max(nm1)), min_quality=min(qs),
                tolerance=tol)
    check(float(np.median(nm1)) <= NMSE_LIMIT_DB and min(qs) >= MIN_QUALITY,
          f"one-card reference off band: {nm1.tolist()} {qs}")

    a_b = Pair(jnp.broadcast_to(ap.re, (batch,) + ap.re.shape),
               jnp.broadcast_to(ap.im, (batch,) + ap.im.shape))
    for mb, mr in ((1, 4), (2, 2)):
        mesh = make_mesh(batch=mb, rows=mr)
        a_sh, b_sh = problem_sharding(mesh)
        a_d = Pair(jax.device_put(a_b.re, a_sh), jax.device_put(a_b.im, a_sh))
        b_d = jax.device_put(b, b_sh)
        t0 = time.perf_counter()
        x, q = jax.block_until_ready(solve_lowrank_multi_sharded_pair(
            mesh, keys, a_d, b_d, nt, nt, cfg))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x, q = jax.block_until_ready(solve_lowrank_multi_sharded_pair(
            mesh, keys, a_d, b_d, nt, nt, cfg))
        dt = time.perf_counter() - t0
        nm = nmse_db(_complex(x), x_true)
        q = np.asarray(q)
        report.line(f"mesh4-batch{mb}x-rows{mr}", recoveries_per_s=batch / dt,
                    compile_s=first_s - dt,
                    median_nmse_db=float(np.median(nm)),
                    worst_nmse_db=float(np.max(nm)),
                    min_quality=float(q.min()), tolerance=tol)
        check(float(np.median(nm)) <= NMSE_LIMIT_DB,
              f"mesh {mb}x{mr}: median NMSE {np.median(nm):.2f} dB")
        check(float(q.min()) >= MIN_QUALITY,
              f"mesh {mb}x{mr}: min quality {q.min():.4f}")


class Sizes(NamedTuple):
    """Widths of the one-card phases."""

    nt: int = 16          #: batch, single, trajectory and testbed array
    m: int = 1024         #: probes of the 16x16 phases (4n)
    batch: int = 64       #: bench batch
    nt_ura: int = 32      #: full URA
    m_ura: int = 4096
    batch_ura: int = 8
    rounds: int = 64      #: testbed campaign (pipeline/testbed.py defaults)
    sectors: int = 62


def main_phases(report: Report, sz: Sizes = Sizes()) -> None:
    import jax
    from twoace.config import AdmmConfig

    nt = sz.nt
    ap, b, x_true = build_problem(nt, nt, sz.m, sz.batch, seed=1)
    cold = AdmmConfig()
    warm = AdmmConfig(maxiter=500, warm_iters=80, stage1_maxiter=120,
                      stage2_maxiter=160)
    tol = f"median<={NMSE_LIMIT_DB}dB,quality>={MIN_QUALITY}"
    for name, cfg in (("batch-cold", cold), ("batch-warm80", warm)):
        stats = batch_phase(ap, b, x_true, nt, nt, cfg)
        report.line(name, **stats, precision=cfg.matmul_precision,
                    tolerance=tol)
        check_accuracy(name, stats)

    jax.clear_caches()
    ap32, b32, x32 = build_problem(sz.nt_ura, sz.nt_ura, sz.m_ura,
                                   sz.batch_ura, seed=2)
    stats = batch_phase(ap32, b32, x32, sz.nt_ura, sz.nt_ura, cold)
    report.line("full-ura", **stats, nt=sz.nt_ura, m=sz.m_ura,
                precision=cold.matmul_precision, tolerance=tol)
    check_accuracy("full-ura", stats)

    one = single_phase(ap, b[0], x_true[0], nt, nt, cold)
    report.line("single", **one, nt=nt, m=sz.m, tolerance=tol)
    check(one["nmse_db"] <= NMSE_LIMIT_DB and one["quality"] >= MIN_QUALITY,
          f"single solve off band: {one}")

    r = min(AdmmConfig().rank, nt * nt)
    dev32 = trajectory_deviation(nt, nt, sz.m, r, TRAJ_ITERS, "float32")
    report.line("trajectory-float32", rel_err_x=dev32, iters=TRAJ_ITERS,
                reference="float64 numpy", tolerance=TRAJ_TOL_F32)
    check(dev32 <= TRAJ_TOL_F32,
          f"float32 trajectory deviates {dev32:.3e} > {TRAJ_TOL_F32}")
    dev_def = trajectory_deviation(nt, nt, sz.m, r, TRAJ_ITERS, "default")
    report.line("trajectory-default", rel_err_x=dev_def, iters=TRAJ_ITERS,
                reference="float64 numpy", tolerance="printed only")

    jax.clear_caches()
    tb, runner, ch = testbed_campaign(nt, nt, sz.rounds, sz.sectors)
    report.line("testbed", **tb, tolerance=f"nmse<{TESTBED_NMSE_BOUND}")
    check(tb["nmse"] < TESTBED_NMSE_BOUND,
          f"testbed NMSE {tb['nmse']:.4f} >= {TESTBED_NMSE_BOUND}")

    # the same campaign through the CLI (same solver shapes: no compile),
    # on the platform this process runs on ("gpu" on the card)
    platform = jax.default_backend()
    summary = cli_testbed(["testbed", "--nt", str(nt), "--nr", str(nt),
                           "--rounds", str(sz.rounds),
                           "--sectors", str(sz.sectors),
                           "--paths", "2", "--noise-dbm", "0",
                           "--platform", platform])
    cli_db = summary["nmse_db_final"]
    report.line("cli-testbed", nmse_db_final=cli_db,
                tolerance=f"nmse<{TESTBED_NMSE_BOUND},"
                          f"|cli-library|<={TESTBED_CLI_DB}dB")
    check(cli_db is not None and 10 ** (cli_db / 10) < TESTBED_NMSE_BOUND,
          f"CLI testbed NMSE {cli_db}")
    check(abs(cli_db - tb["nmse_db"]) <= TESTBED_CLI_DB,
          f"CLI testbed {cli_db} dB != library {tb['nmse_db']} dB")

    # (c) the top budget's recovery from the same campaign data, on this
    # device (the estimate's compiled solver) and on the CPU
    m_top = tb["m_grid"][-1]
    here = testbed_on_device(runner, ch, m_top)
    jax.clear_caches()
    on_cpu = testbed_on_device(runner, ch, m_top, jax.devices("cpu")[0])
    diff = abs(here - on_cpu)
    report.line("testbed-vs-cpu", m=m_top, nmse_db=here,
                cpu_nmse_db=on_cpu, diff_db=diff,
                tolerance=f"|gpu-cpu|<={TESTBED_PARITY_DB}dB")
    check(diff <= TESTBED_PARITY_DB,
          f"testbed differs from the CPU by {diff:.3f} dB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the 4-GPU sharded phase")
    ap.add_argument("--out", help="also write every result to this JSON")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax
    from twoace.utils.device import jax_device, query_nvidia_smi, require_gpu

    require_gpu()
    if args.mesh4:
        check_mesh4_devices(jax.devices())
    device = jax_device()
    smi = query_nvidia_smi().strip()
    print(f"device_kind={device['kind']} count={device['count']} "
          f"jax={jax.__version__}", flush=True)
    print(smi, flush=True)
    report = Report(card=smi.splitlines()[0])
    t0 = time.perf_counter()
    if args.mesh4:
        mesh4_phase(report)
    else:
        main_phases(report)
    report.line("total", seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": device, "nvidia_smi": smi,
                       "results": report.results}, f, indent=1)
    print(ok_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
