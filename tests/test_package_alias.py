"""The package's deprecated import name resolves to ``twoace`` itself."""

import importlib
import os
import subprocess
import sys
import warnings

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _aliases():
    """Packages at the repo root that declare themselves aliases of
    ``twoace`` (``ALIAS_OF = "twoace"`` in their ``__init__``)."""
    out = []
    for name in sorted(os.listdir(ROOT)):
        init = os.path.join(ROOT, name, "__init__.py")
        if os.path.isfile(init) and 'ALIAS_OF = "twoace"' in open(init).read():
            out.append(name)
    return out


ALIASES = _aliases()


def test_alias_exists():
    assert len(ALIASES) == 1


@pytest.mark.parametrize("sub", ["", ".config", ".ops.pair_solver",
                                 ".pipeline.testbed", ".parallel"])
def test_alias_is_the_same_module(sub):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        old = importlib.import_module(ALIASES[0] + sub)
    new = importlib.import_module("twoace" + sub)
    assert old is new
    assert new.__spec__.name == "twoace" + sub
    assert new.__name__ == "twoace" + sub


def test_alias_warns_in_a_fresh_process():
    code = f"import {ALIASES[0]}.ops.cplx as c, twoace.ops.cplx as d; " \
           "assert c is d"
    p = subprocess.run([sys.executable, "-W", "error::DeprecationWarning",
                        "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)
    assert p.returncode != 0
    assert "deprecated; import 'twoace' instead" in p.stderr

