"""2ACE: a compressive mmWave channel-estimation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
2ACE reference (gavinsyw/2ACE-mmWave-Channel-Estimation, MobiHoc '23):
magnitude-only (RSS) CSI recovery through analog beamforming codebooks, with
the spectral-profile ADMM solver family, PhaseLift/PLOMP/PLGAMP/CPRL
baselines, codebook generation/selection, evaluation, and mobility tracking.

Subpackages
-----------
- ``models``:   channel, dictionary, and measurement models (ref L3)
- ``ops``:      solvers and prox/eig kernels (ref L5)
- ``sensing``:  codebooks, sensing matrices, beam selection (ref L1/L4)
- ``parallel``: meshes, sharded solvers, multi-device execution (new)
- ``pipeline``: end-to-end entry points — recovery, simulation, mobility,
                testbed orchestration (ref L2/L6)
- ``utils``:    metrics, units, PRNG, profiling, checkpointing
"""

import os

__version__ = "0.1.0"

#: the checkout this package lives in (parent of the package directory)
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    is ``<checkout>/.jax_cache`` (listed in ``.gitignore``), a fixed path so
    every process of one checkout hits the same entries.
    """
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_DIR, ".jax_cache"))


def _enable_persistent_compile_cache() -> None:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    The staged batch solver is a large XLA graph; with the cache every
    shape is compiled once per checkout.  When ``JAX_COMPILATION_CACHE_DIR``
    is set JAX reads it itself, so nothing is set in code.
    """
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


_enable_persistent_compile_cache()

from . import config  # noqa: F401,E402
from .config import (  # noqa: F401
    AdmmConfig,
    ArrayConfig,
    ChannelConfig,
    MethodFlags,
    PhaseLiftConfig,
    SpectralProfileConfig,
    TwoStageConfig,
    probe_budget_grid,
)
