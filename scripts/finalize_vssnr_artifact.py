#!/usr/bin/env python
"""Finalize the Vs_SNR regression artifact: VSSNR_<tag>.json (+ .png).

Reads VSSNR_<tag>.npz (produced by the CLI:

  python -m twoace vs-snr --nt 16 --nr 16 --trials 10 --maxiter 500 \
      --restarts 3 --paths 3 --beam Random_Phase_State --search-range 95 \
      --snr-grid 0 5 10 15 20 25 --m 529 \
      --methods admm_lowrank_v4 plomp plgamp --seed 1 --platform cpu \
      --out VSSNR_<tag>.npz

) and writes the machine-checkable curves with per-trial std columns and
the explained A2-vs-PLOMP boundary (ANALYSIS_lowsnr_r05.json), which
tests/test_artifacts.py pins.

Usage: python scripts/finalize_vssnr_artifact.py [tag]
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tag = sys.argv[1] if len(sys.argv) > 1 else "r05"
    data = np.load(os.path.join(ROOT, f"VSSNR_{tag}.npz"))
    grid = data["snr_grid"].tolist()
    curves = {k[len("nmse_"):]: data[k] for k in data.files
              if k.startswith("nmse_") and not k.startswith("nmse_trials_")}
    trials = {k[len("nmse_trials_"):]: data[k] for k in data.files
              if k.startswith("nmse_trials_")}

    def db_list(v):
        db = (10 * np.log10(np.maximum(v, 1e-30))).round(2)
        return [float(x) if np.isfinite(x) else None for x in db]

    nmse_db = {k: db_list(v) for k, v in curves.items()}
    nmse_db_std = {}
    for k, tv in trials.items():
        db = 10 * np.log10(np.maximum(tv, 1e-30))
        nmse_db_std[k] = [round(float(np.std(row)), 2) for row in db]

    out = {
        "config": {
            "nt": 16, "nr": 16, "paths": 3, "m": 529,
            "searching_area_deg": 95, "trials": 10, "maxiter": 500,
            "restarts": 3, "beam": "Random_Phase_State", "seed": 1,
            "gate": "shipped noise-aware collapse-only GAMP->OMP gate",
            "ref": "Vs_SNR_par.m sweep at the VSM grid's 6th probe budget "
                   "(A2only.m:110-111); NOTE the reference's own Vs_SNR "
                   "campaign never runs A2 (PLGAMP-only method set, "
                   "Numerical_Simulation/Vs_SNR_par.m:105-113)",
        },
        "snr_grid_db": grid,
        "nmse_db": nmse_db,
        "nmse_db_std": nmse_db_std,
        "boundary": "A2 < PLOMP below the crossover and >= above it — a "
                    "prior-capacity mismatch (low-rank+profile dof vs "
                    "L-sparse dof), root-caused with oracle experiments "
                    "in ANALYSIS_lowsnr_r05.json: truth-initialized ADMM "
                    "still walks away at SNR 0, so no solver fix exists; "
                    "A2 overtakes where PLOMP saturates at its off-grid "
                    "leakage floor.",
    }
    with open(os.path.join(ROOT, f"VSSNR_{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)

    sys.path.insert(0, ROOT)
    from twoace.utils.plotting import plot_error_vs_grid

    plot_error_vs_grid(np.asarray(grid), curves,
                       xlabel="SNR (dB), 16x16, m=529",
                       path=os.path.join(ROOT, f"VSSNR_{tag}.png"))
    print(json.dumps(out["nmse_db"]))


if __name__ == "__main__":
    main()
