#!/usr/bin/env python
"""VS_SR campaign at the reference's semantics -> VSSR_r05.json + .png
(VERDICT r04 #2: replace the all-NaN NMSE-target artifact).

Reference configuration (VS_SR_par.m + sub_VS_SR_par.m): 12x12 array,
L = 1 dominant path + Rician K = 5, SNR 0 dB, Directional_Beam_Angular,
per-range (M, G) grids from the table, MAEE targets {0.6, 0.8, 1.0} deg
selected by closest match (argmin |MAEE - target|), reported as total
measurements M^2.  The A2 row rides along via the H-domain dictionary
projection (metrics.sparse_projection_omp) — the reference's figure only
plots PLGAMP and PerfectPhaseCS; A2 is this framework's extension row.

Run:  python scripts/run_vssr_r05.py [trials]     (CPU, ~1-2 h)
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np          # noqa: E402
import jax                  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    import twoace as t2
    from twoace.pipeline import SimulationConfig
    from twoace.pipeline.simulation import measurements_needed_vs_range
    from twoace.utils.plotting import plot_measurements_vs_range

    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    ranges = [20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0]
    sim = SimulationConfig(
        array=t2.ArrayConfig(nt=12, nr=12),
        channel=t2.ChannelConfig(n_paths=1, rician_k=5),
        snr_db=0.0, add_noise=True,
        beam_method="Directional_Beam_Angular",
        methods=t2.MethodFlags(admm_lowrank_v4=True, plomp=True,
                               plgamp=True),
        admm=t2.AdmmConfig(maxiter=500, n_restarts=3),
        n_trials=trials)
    res = measurements_needed_vs_range(jax.random.PRNGKey(1), ranges,
                                       sim=sim)
    out = {
        "config": {"nt": 12, "nr": 12, "paths": 1, "rician_k": 5,
                   "snr_db": 0.0, "beam": "Directional_Beam_Angular",
                   "trials": trials, "maxiter": 500, "restarts": 3,
                   "grids": "per-range reference table "
                            "(VS_SR_par.m:76-99; G sets NQt=NQr)",
                   "selection": "closest-match MAEE "
                                "(argmin |MAEE - target|, "
                                "VS_SR_par.m:118-119), total = M^2",
                   "seed": 1},
        "ranges_deg": ranges,
        "maee_targets_deg": list(res.maee_targets),
        "m_grids": res.m_grids,
        "g_grids": res.g_grids,
        "m_needed": {k: [[None if np.isnan(x) else int(x) for x in row]
                         for row in v] for k, v in res.m_needed.items()},
        "maee_deg": {k: [[round(float(x), 3) for x in c] for c in v]
                     for k, v in res.maee_curves.items()},
        "nmse_db": {k: [[round(float(10 * np.log10(max(x, 1e-30))), 2)
                         for x in c] for c in v]
                    for k, v in res.nmse_curves.items()},
        "note": "reference figure rows: plgamp + perfect_phase_cs "
                "(VS_SR_par.m:112-115); admm_lowrank_v4 is the framework "
                "extension row via H-domain dictionary projection",
    }
    with open(os.path.join(ROOT, "VSSR_r05.json"), "w") as f:
        json.dump(out, f, indent=1)
    plot_measurements_vs_range(
        ranges, res.m_needed, res.maee_targets,
        os.path.join(ROOT, "VSSR_r05.png"))
    print("wrote VSSR_r05.json / VSSR_r05.png")


if __name__ == "__main__":
    main()
