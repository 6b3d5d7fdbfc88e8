"""Low-SNR A2 diagnosis, part 2: init vs objective.

If ADMM started AT THE TRUTH still walks away to ~0 dB, the magnitude-LS
objective itself is the low-SNR limiter; if truth-init holds a good
solution, the spectral init's noise collapse is the limiter and a sparse
(PLOMP) seed is a deployable fix (solve_lowrank_multi(x_seed=...)).

Variants: spectral (control) / truth-seed (oracle bound) / plomp-seed
(deployable hybrid).
"""
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


def main():
    cfg = t2.ArrayConfig(nt=NT, nr=NT)
    acfg = AdmmConfig()
    flags = MethodFlags(plomp=True, plgamp=False, admm_lowrank_v4=False)
    out = []

    def solve_plain(k, a, bb):
        return solve_lowrank_multi(k, a, bb, cfg.nt, cfg.nr, acfg).x

    def solve_seeded(k, a, bb, seed):
        return solve_lowrank_multi(k, a, bb, cfg.nt, cfg.nr, acfg,
                                   x_seed=seed).x

    v_plain = jax.vmap(solve_plain)
    v_seed = jax.vmap(solve_seeded)

    for i, snr in enumerate(SNRS):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        ks = jax.random.split(key, 4)
        ch = generate_channel(ks[0], cfg, t2.ChannelConfig(n_paths=PATHS,
                                                           rician_k=0),
                              batch=TRIALS)
        rep = sparse_formulation(cfg, ch, SEARCH)
        sensing = generate_sensing_matrix(
            ks[1], "Random_Phase_State", M, 1, cfg, rep.ad,
            aod_range=(-SEARCH / 2, SEARCH / 2),
            aoa_range=(-SEARCH / 2, SEARCH / 2), batch=TRIALS)
        meas = generate_measurement(ks[2], sensing.fw, ch.vec_h, snr, True,
                                    w=None, mt=M)
        b = jnp.sqrt(meas.norm_square)
        keys = jax.random.split(jax.random.fold_in(ks[3], 99), TRIALS)

        seeds_plomp, nmse_plomp = [], []
        for u in range(TRIALS):
            res = recover_sparse(jax.random.fold_in(ks[3], u),
                                 meas.norm_square[u],
                                 sensing.measurement_mat[u], flags, s=PATHS,
                                 noise_power=float(meas.noise_power))
            vec = rep.ad @ res["plomp"]
            seeds_plomp.append(np.asarray(vec))
            nmse_plomp.append(float(nmse_h_projection(
                vec[None], ch.vec_h[u:u + 1])[0]))

        row = {"snr_db": snr,
               "plomp_db": round(10 * np.log10(np.mean(nmse_plomp)), 2)}
        for name, seeds in [("spectral", None),
                            ("truth", jnp.asarray(ch.vec_h)),
                            ("plomp_seed",
                             jnp.asarray(np.stack(seeds_plomp)))]:
            if seeds is None:
                xs = v_plain(keys, sensing.fw, b)
            else:
                xs = v_seed(keys, sensing.fw, b, seeds)
            per = np.asarray(nmse_h_projection(xs, ch.vec_h))
            row[f"a2_{name}_db"] = round(
                float(10 * np.log10(np.mean(per))), 2)
        out.append(row)
        print(json.dumps(row), flush=True)
    with open("/tmp/diag_lowsnr_init.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
