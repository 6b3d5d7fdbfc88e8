"""Diagnose A2's low-SNR behavior (VERDICT r04 #3).

Hypothesis: the fixed quality threshold 0.6 (inferLowRankV4_multi.m:73)
conflates model misfit with the magnitude-domain noise floor.  The CV
quality of a PERFECT estimate is ~ 1 - sqrt(sigma^2/2 / E|y|^2), which
drops below 0.6 between SNR 5 and 0 dB — so at low SNR the rank-1 retry
fires on every restart regardless of fit, and the full refine runs
rank-constrained on a 3-path channel.

Variants per SNR cell:
  default     : shipped config (thr = 0.6)
  no_rank1    : thr = -1 (retry never fires; refine always takes the
                "quality ok" branch)
  noise_aware : thr_eff = 1 - sqrt((1-thr)^2 + rho^2) with
                rho = sqrt(m sigma^2 / 2) / ||B|| — misfit and noise
                residuals add in quadrature

Usage: python scripts/diag_lowsnr.py [nt] [m] [trials]
"""
import dataclasses
import json
import sys

sys.path.insert(0, "/root/repo")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import twoace as t2
from twoace.config import AdmmConfig, MethodFlags
from twoace.models import (generate_channel, generate_measurement,
                               sparse_formulation)
from twoace.ops.admm import solve_lowrank_multi
from twoace.ops.dispatch import recover_sparse
from twoace.sensing import generate_sensing_matrix
from twoace.utils.metrics import nmse_h_projection

NT = int(sys.argv[1]) if len(sys.argv) > 1 else 8
M = int(sys.argv[2]) if len(sys.argv) > 2 else 150
TRIALS = int(sys.argv[3]) if len(sys.argv) > 3 else 6
SEARCH = 95.0
PATHS = 3
SNRS = [0.0, 5.0, 10.0]


def cell(key, snr_db):
    cfg = t2.ArrayConfig(nt=NT, nr=NT)
    ks = jax.random.split(key, 4)
    ch = generate_channel(ks[0], cfg, t2.ChannelConfig(n_paths=PATHS,
                                                       rician_k=0),
                          batch=TRIALS)
    rep = sparse_formulation(cfg, ch, SEARCH)
    sensing = generate_sensing_matrix(
        ks[1], "Random_Phase_State", M, 1, cfg, rep.ad,
        aod_range=(-SEARCH / 2, SEARCH / 2),
        aoa_range=(-SEARCH / 2, SEARCH / 2), batch=TRIALS)
    meas = generate_measurement(ks[2], sensing.fw, ch.vec_h, snr_db, True,
                                w=None, mt=M)
    return cfg, ch, rep, sensing, meas, ks[3]


def a2_nmse(key, cfg, ch, sensing, meas, admm_cfg):
    keys = jax.random.split(jax.random.fold_in(key, 999), TRIALS)
    b = jnp.sqrt(meas.norm_square)

    def solve(k, a, bb):
        res = solve_lowrank_multi(k, a, bb, cfg.nt, cfg.nr, admm_cfg)
        return res.x, res.quality

    xs, qs = jax.vmap(solve)(keys, sensing.fw, b)
    per = np.asarray(nmse_h_projection(xs, ch.vec_h))
    return (10 * np.log10(np.mean(per)), np.asarray(qs))


def main():
    out = []
    for i, snr in enumerate(SNRS):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        cfg, ch, rep, sensing, meas, k_rec = cell(key, snr)

        # PLOMP opponent
        flags = MethodFlags(plomp=True, plgamp=False, admm_lowrank_v4=False)
        per_pl = []
        for u in range(TRIALS):
            res = recover_sparse(jax.random.fold_in(k_rec, u),
                                 meas.norm_square[u],
                                 sensing.measurement_mat[u], flags, s=PATHS,
                                 noise_power=float(meas.noise_power))
            z = res["plomp"]
            vec = rep.ad @ z
            per_pl.append(float(nmse_h_projection(vec[None],
                                                  ch.vec_h[u:u + 1])[0]))
        plomp_db = 10 * np.log10(np.mean(per_pl))

        # noise-aware effective threshold (quadrature composition)
        sig2 = float(meas.noise_power)
        bnorm2 = float(np.mean(np.sum(np.asarray(meas.norm_square), axis=1)))
        rho = np.sqrt(M * sig2 / 2.0 / bnorm2)
        thr_eff = 1.0 - float(np.sqrt(0.4 ** 2 + rho ** 2))

        row = {"snr_db": snr, "plomp_db": round(plomp_db, 2),
               "rho_noise": round(float(rho), 3),
               "thr_eff": round(thr_eff, 3)}
        for name, thr in [("default", 0.6), ("no_rank1", -1.0),
                          ("noise_aware", thr_eff)]:
            acfg = dataclasses.replace(AdmmConfig(), quality_threshold=thr)
            db, qs = a2_nmse(k_rec, cfg, ch, sensing, meas, acfg)
            row[f"a2_{name}_db"] = round(float(db), 2)
            row[f"a2_{name}_q"] = [round(float(q), 3) for q in qs]
        out.append(row)
        print(json.dumps(row), flush=True)
    with open("/tmp/diag_lowsnr.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
