#!/usr/bin/env python
"""Finalize the Vs_M accuracy-curve regression artifact.

Reads the raw sweep output (VSM_<tag>.npz, produced by the CLI:

  python -m twoace vs-m --nt 16 --nr 16 --trials 10 --maxiter 500 \
      --restarts 3 --paths 3 --beam Random_Phase_State --search-range 95 \
      --snr 20 --m-grid 4 36 121 225 361 529 784 1024 \
      --methods admm_lowrank_v4 phaselift plomp plgamp --seed 1 \
      --platform cpu --out VSM_<tag>.npz

— the reference probe-budget grid of A2only.m:110-111 at the testbed's
16x16 / 95-degree search configuration, A2 vs PhaseLift vs PLOMP/PLGAMP
vs perfect/noisy-phase CS) and writes:
  - VSM_<tag>.json   machine-checkable curves (mean + per-trial std)
  - VSM_<tag>.png    the paper-style error-vs-M figure

tests/test_artifacts.py pins coarse regression bounds on the committed
JSON (the 2-8 dB improvement claim of the reference README.md:7 made
machine-checkable).

Usage: python scripts/finalize_vsm_artifact.py [round_tag [trials]]
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    tag = sys.argv[1] if len(sys.argv) > 1 else "r04"
    npz = os.path.join(ROOT, f"VSM_{tag}.npz")
    data = np.load(npz)
    m_grid = data["m_grid"].tolist()
    curves = {k[len("nmse_"):]: data[k] for k in data.files
              if k.startswith("nmse_") and not k.startswith("nmse_trials_")}
    trials = {k[len("nmse_trials_"):]: data[k] for k in data.files
              if k.startswith("nmse_trials_")}
    n_trials = next(iter(trials.values())).shape[1] if trials else None

    def db_list(v):
        db = (10 * np.log10(np.maximum(v, 1e-30))).round(2)
        # strict JSON: non-finite cells -> null
        return [float(x) if np.isfinite(x) else None for x in db]

    nmse_db = {k: db_list(v) for k, v in curves.items()}
    # per-point std of the PER-TRIAL dB values (variance control,
    # VERDICT r03 #1c)
    nmse_db_std = {}
    for k, tv in trials.items():
        db = 10 * np.log10(np.maximum(tv, 1e-30))
        nmse_db_std[k] = [round(float(np.std(row)), 2) for row in db]

    out = {
        "config": {
            "nt": 16, "nr": 16, "paths": 3, "searching_area_deg": 95,
            "snr_db": 20, "trials": n_trials, "maxiter": 500, "restarts": 3,
            "beam": "Random_Phase_State", "seed": 1,
            "m_grid_ref": "A2only.m:110-111",
            "gate": "curves generated under the SHIPPED noise-aware "
                    "collapse-only GAMP->OMP gate (ops/twostage.py, "
                    "ops/cpr_baselines.py; r05 closes the r04 "
                    "gate_provenance caveat)",
        },
        "m_grid": m_grid,
        "nmse_db": nmse_db,
        "nmse_db_std": nmse_db_std,
    }
    with open(os.path.join(ROOT, f"VSM_{tag}.json"), "w") as f:
        json.dump(out, f, indent=2)

    sys.path.insert(0, ROOT)
    from twoace.utils.plotting import plot_error_vs_grid

    plot_error_vs_grid(
        np.asarray(m_grid), curves,
        xlabel="measurements M (16x16 CSI, SNR 20 dB)",
        path=os.path.join(ROOT, f"VSM_{tag}.png"))
    print(json.dumps(out["nmse_db"]))


if __name__ == "__main__":
    main()
