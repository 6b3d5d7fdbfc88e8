"""Command-line entry points for the framework.

The reference exposes its functionality through 11 MATLAB entry scripts
(``Numerical_Simulation/main_programs/*.m``, SURVEY §2.5 O3) plus the
testbed driver ``main/main.py`` (O1), each a copy-pasted config block.
Here the same campaigns are one CLI::

    python -m twoace vs-m       --m-grid 25 49 100 --trials 4
    python -m twoace vs-snr     --snr-grid -10 0 10 --m 100
    python -m twoace vs-sr     --ranges 30 60 90 --m-grid 25 49 100
    python -m twoace mobility   --windows 12
    python -m twoace testbed    --nt 8 --nr 8 --method a2only
    python -m twoace recover    --probes rss.npz --method a2only

Every command prints one JSON summary line and (with ``--out``) saves the
full arrays as ``.npz`` — the reference saves ``.mat`` per-config
(ref: Vs_M_par.m:214-217, main/main.py:483); ``.npz`` is the NumPy-native
equivalent and ``scipy.io.savemat`` interop is a flag away (``--mat``).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def _json_default(o):
    if isinstance(o, np.ndarray):
        return _sanitize(o.tolist())
    if isinstance(o, np.floating):
        v = o.item()
        return None if math.isnan(v) else v
    if isinstance(o, np.integer):
        return o.item()
    return str(o)


def _sanitize(o):
    """Map NaN to null so the summary line is strict JSON (jq/JSON.parse
    reject bare NaN)."""
    if isinstance(o, float) and math.isnan(o):
        return None
    if isinstance(o, dict):
        return {k: _sanitize(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_sanitize(v) for v in o]
    if isinstance(o, np.ndarray):
        return _sanitize(o.tolist())
    return o


def _emit(summary: dict, arrays: dict, args) -> None:
    print(json.dumps(_sanitize(summary), default=_json_default))
    if getattr(args, "out", None):
        if getattr(args, "mat", False):
            import scipy.io as sio

            sio.savemat(args.out, {k: np.asarray(v)
                                   for k, v in arrays.items()})
        else:
            np.savez(args.out, **arrays)


def _setup_platform(args) -> None:
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)


def _sim_config(args):
    import twoace as t2
    from twoace.pipeline import SimulationConfig

    methods = t2.MethodFlags(**{m: True for m in args.methods})
    return SimulationConfig(
        array=t2.ArrayConfig(nt=args.nt, nr=args.nr),
        channel=t2.ChannelConfig(n_paths=args.paths,
                                 rician_k=0 if args.paths > 1 else 5),
        snr_db=args.snr, add_noise=not args.noiseless,
        beam_method=args.beam,
        methods=methods,
        admm=t2.AdmmConfig(maxiter=args.maxiter, n_restarts=args.restarts),
        n_trials=args.trials, impl=args.impl)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--nt", type=int, default=12)
    p.add_argument("--nr", type=int, default=12)
    p.add_argument("--paths", type=int, default=1)
    p.add_argument("--snr", type=float, default=0.0)
    p.add_argument("--noiseless", action="store_true")
    p.add_argument("--trials", type=int, default=4,
                   help="Monte-Carlo trials (ref parfor loop count)")
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--restarts", type=int, default=3)
    p.add_argument("--methods", nargs="+",
                   default=["admm_lowrank_v4"],
                   help="MethodFlags fields to enable (e.g. admm_lowrank_v4 "
                        "plomp plgamp phaselift cs_perfect_phase)")
    p.add_argument("--impl", choices=["complex", "pair"], default="complex")
    p.add_argument("--beam", default="Directional_Beam_Angular",
                   choices=["Directional_Beam_Angular", "Directional_Beam",
                            "Random_Phase_State", "Random_Beam_Bayes",
                            "Directional_Random_Beam", "Region_Random_Beam"],
                   help="sensing mode; random modes read --m-grid as TOTAL "
                        "probe rows (ref A2only.m:110-111), directional "
                        "modes as per-side beam counts (ref Vs_M_par.m)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="save full arrays to this .npz/.mat path")
    p.add_argument("--mat", action="store_true",
                   help="save --out as MATLAB .mat instead of .npz")
    p.add_argument("--platform", choices=["cpu", "gpu", ""], default="",
                   help="force a JAX platform (default: auto)")


def cmd_vs_m(args) -> None:
    """Error vs measurement count (ref: Vs_M{,_par}.m)."""
    import jax
    from twoace.pipeline import sweep_measurements

    res = sweep_measurements(jax.random.PRNGKey(args.seed), args.m_grid,
                             _sim_config(args),
                             searching_area=args.search_range)
    summary = {"cmd": "vs-m", "m_grid": res.grid,
               "nmse_db": {k: 10 * np.log10(np.maximum(v, 1e-30))
                           for k, v in res.nmse.items()},
               "aoda_err_deg": res.aoda_err}
    arrays = {"m_grid": res.grid}
    arrays.update({f"nmse_{k}": v for k, v in res.nmse.items()})
    arrays.update({f"ang_{k}": v for k, v in res.aoda_err.items()})
    # per-trial NMSE (len(grid), trials): variance columns for the
    # committed accuracy artifacts (VSM_r04+)
    arrays.update({f"nmse_trials_{k}": v
                   for k, v in (res.nmse_trials or {}).items()})
    _emit(summary, arrays, args)


def cmd_vs_snr(args) -> None:
    """Error vs SNR (ref: Vs_SNR{,_par}.m)."""
    import jax
    from twoace.pipeline import sweep_snr

    res = sweep_snr(jax.random.PRNGKey(args.seed), args.snr_grid, args.m,
                    _sim_config(args), searching_area=args.search_range)
    summary = {"cmd": "vs-snr", "snr_grid": res.grid,
               "nmse_db": {k: 10 * np.log10(np.maximum(v, 1e-30))
                           for k, v in res.nmse.items()}}
    arrays = {"snr_grid": res.grid}
    arrays.update({f"nmse_{k}": v for k, v in res.nmse.items()})
    # per-trial NMSE (len(grid), trials): variance columns, mirroring
    # cmd_vs_m (the round-4 variance-control policy)
    arrays.update({f"nmse_trials_{k}": v
                   for k, v in (res.nmse_trials or {}).items()})
    _emit(summary, arrays, args)


def cmd_vs_sr(args) -> None:
    """Probes needed vs search range (ref: VS_SR_par.m + sub_VS_SR_par.m):
    per-range (M, G) grids, closest-match MAEE targets."""
    import jax
    from twoace.pipeline import measurements_needed_vs_range

    res = measurements_needed_vs_range(
        jax.random.PRNGKey(args.seed), args.ranges, m_grid=args.m_grid,
        g_grid=args.g_grid, maee_targets=tuple(args.targets),
        sim=_sim_config(args))
    summary = {"cmd": "vs-sr", "ranges_deg": args.ranges,
               "maee_targets_deg": list(res.maee_targets),
               "m_needed": res.m_needed,
               "m_grids": res.m_grids, "g_grids": res.g_grids,
               "maee_deg": {k: [list(np.round(c, 3)) for c in v]
                            for k, v in res.maee_curves.items()}}
    arrays = {"ranges_deg": np.asarray(args.ranges),
              "maee_targets": np.asarray(res.maee_targets)}
    arrays.update({f"m_needed_{k}": v for k, v in res.m_needed.items()})
    for r_i, sr in enumerate(args.ranges):
        tag = f"r{int(round(sr))}"
        arrays[f"m_grid_{tag}"] = np.asarray(res.m_grids[r_i])
        arrays[f"g_grid_{tag}"] = np.asarray(res.g_grids[r_i])
        for k in res.maee_curves:
            arrays[f"maee_{k}_{tag}"] = np.asarray(res.maee_curves[k][r_i])
            arrays[f"nmse_{k}_{tag}"] = np.asarray(res.nmse_curves[k][r_i])
    _emit(summary, arrays, args)


def cmd_mobility(args) -> None:
    """Adaptive mobility tracking on a synthetic Brownian trace
    (ref: RSS_Mobility_simu.m)."""
    import jax
    import twoace as t2
    from twoace.pipeline import (SimulatedMobilityConfig, brownian_trace,
                                     track_simulated)

    cfg = t2.ArrayConfig(nt=args.nt, nr=args.nr)
    mob = SimulatedMobilityConfig(
        window_probes=args.window_probes, threshold=args.threshold,
        max_angle_change_deg=args.angle_change,
        admm=t2.AdmmConfig(maxiter=args.maxiter, n_restarts=1))
    key = jax.random.PRNGKey(args.seed)
    cb, rss, vec_h = brownian_trace(key, cfg, mob, n_windows=args.windows)
    trace = track_simulated(jax.random.fold_in(key, 1), cb, rss, cfg, mob)
    summary = {"cmd": "mobility", "windows": args.windows,
               "mean_rss_error": float(np.mean(trace.rss_error)),
               "mean_probe_budget": float(np.mean(trace.probe_budget)),
               "probe_budget": trace.probe_budget}
    _emit(summary, {"rss_error": trace.rss_error,
                    "probe_budget": trace.probe_budget,
                    "estimates": trace.estimates,
                    "vec_h_true": np.asarray(vec_h)}, args)


def cmd_testbed(args) -> None:
    """End-to-end synthetic testbed campaign (ref: main/main.py)."""
    import jax
    import jax.numpy as jnp
    import twoace as t2
    from twoace.models import generate_channel
    from twoace.pipeline import CampaignConfig, TestbedConfig, TestbedRunner
    from twoace.sensing.provider import SyntheticProvider
    from twoace.utils.metrics import nmse_h_projection

    cfg = t2.ArrayConfig(nt=args.nt, nr=args.nr)
    key = jax.random.PRNGKey(args.seed)
    ch = generate_channel(key, cfg, t2.ChannelConfig(n_paths=args.paths,
                                                     rician_k=0), batch=1)
    prov = SyntheticProvider(vec_h=ch.vec_h[0] * 3e-4,
                             noise_dbm_std=args.noise_dbm)
    runner = TestbedRunner(
        TestbedConfig(array=cfg, n_random_rounds=args.rounds,
                      sectors_per_round=args.sectors), prov, key=key)
    runner.run_random_campaign()
    cc = CampaignConfig(array=cfg, n_paths=args.paths,
                        multires=args.method == "multires",
                        admm=t2.AdmmConfig(maxiter=args.maxiter,
                                           n_restarts=args.restarts))
    method = {"multires": "multiresolution"}.get(args.method, args.method)
    out = runner.estimate("random", method, cc=cc)
    h = out.h_amp[-1, 0] * np.exp(1j * out.h_angle[-1, 0])
    nmse = float(nmse_h_projection(jnp.asarray(h)[None],
                                   ch.vec_h * 3e-4)[0])
    summary = {"cmd": "testbed", "method": args.method,
               "m_grid": out.m_grid,
               "nmse_db_final": 10 * np.log10(max(nmse, 1e-30))}
    _emit(summary, {"h_amp": out.h_amp, "h_angle": out.h_angle,
                    "m_grid": np.asarray(out.m_grid)}, args)


def cmd_recover(args) -> None:
    """One-shot recovery from a recorded probe file (ref:
    Infer_channel_ADMM.m / VS_M_real_rss.m semantics).

    The ``--probes`` .npz must hold ``cb_rows`` (m, nt*nr) complex probe
    rows and ``rss_dbm`` (m,) measured RSS in dBm.
    """
    from twoace.pipeline.recovery import (CampaignConfig,
                                              recover_a2nuclear, recover_a2only,
                                              recover_multiresolution,
                                              recover_phaselift)
    import twoace as t2

    data = np.load(args.probes)
    cb_rows, rss = data["cb_rows"], data["rss_dbm"]
    fn = {"a2only": recover_a2only, "a2nuclear": recover_a2nuclear,
          "multires": recover_multiresolution,
          "phaselift": recover_phaselift}[args.method]
    cc = CampaignConfig(
        array=t2.ArrayConfig(nt=args.nt, nr=args.nr),
        multires=args.method == "multires",
        admm=t2.AdmmConfig(maxiter=args.maxiter, n_restarts=args.restarts))
    out = fn(cb_rows, rss, seed_id=args.seed, cc=cc)
    summary = {"cmd": "recover", "method": args.method,
               "m_grid": out.m_grid}
    _emit(summary, {"h_amp": out.h_amp, "h_angle": out.h_angle,
                    "m_grid": np.asarray(out.m_grid)}, args)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="twoace",
        description="2ACE compressive channel estimation")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("vs-m", help=cmd_vs_m.__doc__)
    _add_common(p)
    p.add_argument("--m-grid", type=int, nargs="+",
                   default=[25, 49, 100, 196])
    p.add_argument("--search-range", type=float, default=60.0)
    p.set_defaults(fn=cmd_vs_m)

    p = sub.add_parser("vs-snr", help=cmd_vs_snr.__doc__)
    _add_common(p)
    p.add_argument("--snr-grid", type=float, nargs="+",
                   default=[-10, -5, 0, 5, 10])
    p.add_argument("--m", type=int, default=100)
    p.add_argument("--search-range", type=float, default=60.0)
    p.set_defaults(fn=cmd_vs_snr)

    p = sub.add_parser("vs-sr", help=cmd_vs_sr.__doc__)
    _add_common(p)
    p.add_argument("--ranges", type=float, nargs="+",
                   default=[20, 30, 40, 50, 60, 70, 80],
                   help="search ranges; the reference's per-range (M, G) "
                        "grids apply unless --m-grid overrides")
    p.add_argument("--m-grid", type=int, nargs="+", default=None,
                   help="override: one shared per-side beam grid")
    p.add_argument("--g-grid", type=int, nargs="+", default=None,
                   help="override: dictionary sizes paired with --m-grid")
    p.add_argument("--targets", type=float, nargs="+", default=[0.6, 0.8, 1.0],
                   help="MAEE targets in degrees (VS_SR_par.m:104-106)")
    p.set_defaults(fn=cmd_vs_sr)

    p = sub.add_parser("mobility", help=cmd_mobility.__doc__)
    _add_common(p)
    p.add_argument("--windows", type=int, default=12)
    p.add_argument("--window-probes", type=int, default=100)
    p.add_argument("--threshold", type=float, default=0.2)
    p.add_argument("--angle-change", type=float, default=1.0)
    p.set_defaults(fn=cmd_mobility)

    p = sub.add_parser("testbed", help=cmd_testbed.__doc__)
    _add_common(p)
    p.add_argument("--method", default="a2only",
                   choices=["a2only", "a2nuclear", "multires", "phaselift"])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--sectors", type=int, default=8)
    p.add_argument("--noise-dbm", type=float, default=0.3)
    p.set_defaults(fn=cmd_testbed)

    p = sub.add_parser("recover", help=cmd_recover.__doc__)
    _add_common(p)
    p.add_argument("--probes", required=True,
                   help=".npz with cb_rows (m,n) and rss_dbm (m,)")
    p.add_argument("--method", default="a2only",
                   choices=["a2only", "a2nuclear", "multires", "phaselift"])
    p.set_defaults(fn=cmd_recover)

    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    _setup_platform(args)
    args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
