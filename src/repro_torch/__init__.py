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
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
