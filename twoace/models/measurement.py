"""RSS measurement model.

JAX rewrite of ``Generate_Measurement``:
  ref: main/src/generate_measurement/Generate_Measurement.m:67-135.

``y = FW vec(H) + n`` with *colored* noise: the reference draws one complex
Gaussian noise matrix per Rx array and combines it through the combiner
columns (``diag(W' * noiseMatrix)``), replicating the same realization across
all Tx probes (ref :110-115).  We reproduce exactly that structure when
``(F, W)`` are provided, and fall back to iid noise otherwise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp


class Measurements(NamedTuple):
    norm_square: jax.Array     #: (U, M) |y|^2 — the RSS the testbed observes
    perfect_phase: jax.Array   #: (U, M) complex y
    noisy_phase: jax.Array     #: (U, M) y with scrambled phase (ref :119-120)
    isnr: jax.Array            #: (U, M) instantaneous SNR per measurement
    noise_power: jax.Array     #: scalar noise power


def _complex_normal(key, shape, dtype):
    kr, ki = jax.random.split(key)
    rdt = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 else jnp.float32
    return ((jax.random.normal(kr, shape, rdt)
             + 1j * jax.random.normal(ki, shape, rdt)) / np.sqrt(2.0)).astype(dtype)


def generate_measurement(key, fw, vec_h, snr_db: float, add_noise: bool = True,
                         w: Optional[jax.Array] = None,
                         mt: Optional[int] = None) -> Measurements:
    """Measure a batch of channels through sensing matrix rows.

    Args:
      key: PRNG key.
      fw: sensing matrix, shape ``(U, M, n)`` or ``(M, n)`` (broadcast over U).
      vec_h: vectorized channels ``(U, n)``.
      snr_db: SNR in dB; signal power normalized to 1 (ref :96-100).
      add_noise: noiseless mode uses noise_power=1e-10 (ref :123-125).
      w: optional per-user combiner ``(U, nr, mr)`` for colored noise
         (ref :110-115).  When given, ``mt`` (number of Tx probes) must divide
         M and the Rx-side noise realization is shared across Tx probes.
    """
    vec_h = jnp.asarray(vec_h)
    if vec_h.ndim == 1:
        vec_h = vec_h[None]
    batch = vec_h.shape[0]
    fw = jnp.asarray(fw)
    if fw.ndim == 2:
        fw = jnp.broadcast_to(fw[None], (batch,) + fw.shape)
    m = fw.shape[1]
    dtype = jnp.result_type(fw.dtype, vec_h.dtype)
    rdt = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 else jnp.float32

    clean = jnp.einsum("umn,un->um", fw, vec_h.astype(dtype))

    if add_noise:
        noise_power = jnp.asarray(10.0 ** (-snr_db / 10.0), rdt)
        if w is not None:
            # Colored noise through the combiner (ref :110-115): one
            # (nr, mr) noise draw per user, identical across the mt Tx probes.
            w = jnp.asarray(w, dtype)
            nr_, mr = w.shape[-2], w.shape[-1]
            mt_ = m // mr if mt is None else mt
            nmat = _complex_normal(key, (batch, nr_, mr), dtype)
            sub = jnp.einsum("urm,urm->um", jnp.conj(w), nmat)  # diag(W' N)
            noise = jnp.tile(sub, (1, mt_)) * jnp.sqrt(noise_power)
        else:
            noise = _complex_normal(key, (batch, m), dtype) * jnp.sqrt(noise_power)
        y = clean + noise
        isnr = jnp.abs(y) ** 2 / jnp.maximum(jnp.abs(noise) ** 2, 1e-30)
    else:
        noise_power = jnp.asarray(1e-10, rdt)
        y = clean
        isnr = jnp.full((batch, m), jnp.inf, rdt)

    # "Noisy phase": multiply by a fresh CN(0,1) draw (ref :119-120) — note
    # the reference scrambles magnitude as well, not just phase.
    key_p = jax.random.fold_in(key, 1)
    noisy_phase = y * _complex_normal(key_p, (batch, m), dtype)

    return Measurements(norm_square=jnp.abs(y) ** 2, perfect_phase=y,
                        noisy_phase=noisy_phase, isnr=isnr,
                        noise_power=noise_power)
