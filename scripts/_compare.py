"""Import another checkout's ``repro_torch`` kernel wrappers beside this
checkout's, for the scripts that time a kernel against a parent commit's
(``torch_*_compare.py --against DIR``).

    from _compare import import_other
    other = import_other("_parent", ["flash_attention"])["flash_attention"]
"""
from __future__ import annotations

import importlib
import os
import sys


def _package_modules() -> list:
    return [k for k in sys.modules
            if k == "repro_torch" or k.startswith("repro_torch.")]


def import_other(root: str, names) -> dict:
    """The modules ``repro_torch.kernels.<name>`` of the checkout at
    ``root`` for each name in ``names``, imported with that checkout's
    own ``repro_torch`` package (so each builds its own kernels through
    its own ``build.load``); this checkout's modules are put back
    afterwards."""
    saved = {k: sys.modules.pop(k) for k in _package_modules()}
    src = os.path.join(os.path.abspath(root), "src")
    sys.path.insert(0, src)
    try:
        return {n: importlib.import_module(f"repro_torch.kernels.{n}")
                for n in names}
    finally:
        sys.path.remove(src)
        for k in _package_modules():
            del sys.modules[k]
        sys.modules.update(saved)
