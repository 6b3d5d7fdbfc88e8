"""Deprecated import name of :mod:`twoace`.

The package was renamed to ``twoace``.  This alias keeps old imports
working: ``import <alias>.X`` returns the very module object ``twoace.X``
(no second copy, so ``isinstance`` checks and jit caches are shared), and
the first import warns with a :class:`DeprecationWarning`.  New code
imports ``twoace``.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import twoace

#: the package this name is an alias of
ALIAS_OF = "twoace"

warnings.warn(f"the package name {__name__!r} is deprecated; import "
              f"{ALIAS_OF!r} instead", DeprecationWarning, stacklevel=2)


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<alias>.X`` to the already-importable ``twoace.X``."""

    def __init__(self, alias: str, target: str):
        self.prefix = alias + "."
        self.target = target
        self.real_specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(self.prefix):
            return None
        return importlib.util.spec_from_loader(fullname, self)

    def create_module(self, spec):
        real = importlib.import_module(
            self.target + "." + spec.name[len(self.prefix):])
        # the import system overwrites __spec__ on the returned module;
        # exec_module puts the real one back
        self.real_specs[spec.name] = real.__spec__
        return real

    def exec_module(self, module):
        module.__spec__ = self.real_specs.pop(module.__spec__.name)


sys.meta_path.insert(0, _AliasFinder(__name__, ALIAS_OF))
# the alias package itself is the real package
sys.modules[__name__] = twoace
