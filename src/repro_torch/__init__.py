"""PyTorch/CUDA port of the ``repro`` package, one slice at a time.

The paper's pipeline runs on it end to end: HFLOP clustering
(:mod:`repro_torch.core`, :mod:`repro_torch.orchestration`), the traffic
GRU (:mod:`repro_torch.models.gru`) trained by continual hierarchical
FedAvg (:mod:`repro_torch.fl`), the tiered replica pool
(:mod:`repro_torch.serving.replica`), and the routing simulator its
measurements calibrate (:mod:`repro_torch.routing`).  Two hand-written
CUDA kernels carry that path, ``gru_seq`` and ``fedavg_reduce``; six
more carry the LM serving slices (:mod:`repro_torch.kernels.ops`).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).

Importing the package itself imports no torch: the numpy-only layers
(``routing``, ``sim``, ``core``, ``telemetry``, ``configs``,
``fl.schedule``) import without it, as the reference's do (contract
LAYER001, checked by ``python -m repro_torch.analysis``), so
``resolve_device`` is resolved on first access (PEP 562).
"""
import importlib

__all__ = ["resolve_device"]


def __getattr__(name):
    if name != "resolve_device":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module("repro_torch.device"), name)
