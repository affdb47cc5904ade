"""Optional-dependency imports that cannot be fooled by parity-test stubs.

The JAX package's ``compat/reference_import.py`` installs ImportError-raising stub modules
into ``sys.modules`` so the torch reference's module-level imports succeed
during parity checks.  Round 3 shipped a bug where the ``pypinyin`` stub
(whose ``pinyin`` attribute was explicitly set) silently hijacked the
first-party Mandarin G2P path in any process that had run a parity check
first.  Every optional import in the framework now goes through
``optional_import``, which rejects stub-marked modules so "the real
package is installed" can never be confused with "a stub is loaded".
"""

from __future__ import annotations

import importlib


def optional_import(name: str):
    """Import ``name`` like ``importlib.import_module`` but raise
    ImportError if the resolved module (or its top-level package) is a
    parity-test stub from ``compat/reference_import.py``."""
    module = importlib.import_module(name)
    root = importlib.import_module(name.partition(".")[0])
    if getattr(module, "__toucan_stub__", False) or \
            getattr(root, "__toucan_stub__", False):
        raise ImportError(
            f"{name!r} in sys.modules is a parity-test stub installed by "
            "the JAX package's compat/reference_import.py, not a real installation")
    return module
