"""Tiered serving subsystem of the port.

Workload generation (numpy-only) is imported eagerly; the torch-backed
engine/replica/scheduler are lazy (PEP 562), as in the reference's
facade, so that numpy-only consumers (the routing simulator sources its
Poisson arrivals from ``serving.workload``) don't pay (or require) the
torch import (contract LAYER002).
"""
import importlib

from repro_torch.serving.workload import (RequestEvent, batched_arrivals,
                                          poisson_request_arrays,
                                          poisson_requests)

_LAZY = {
    "EngineMeasurement": "repro_torch.serving.engine",
    "PagedServeEngine": "repro_torch.serving.engine",
    "ServeEngine": "repro_torch.serving.engine",
    "bucket_len": "repro_torch.serving.engine",
    "PagePool": "repro_torch.serving.page_pool",
    "PagesExhausted": "repro_torch.serving.page_pool",
    "DEFAULT_TIERS": "repro_torch.serving.replica",
    "FAILOVER_ORDER": "repro_torch.serving.replica",
    "ReplicaPool": "repro_torch.serving.replica",
    "TierSpec": "repro_torch.serving.replica",
    "lm_tiers": "repro_torch.serving.replica",
    "paged_lm_tiers": "repro_torch.serving.replica",
    "ContinuousBatchingScheduler": "repro_torch.serving.scheduler",
    "Request": "repro_torch.serving.scheduler",
    "ScheduleStats": "repro_torch.serving.scheduler",
    "requests_from_events": "repro_torch.serving.scheduler",
}

__all__ = ["ContinuousBatchingScheduler", "DEFAULT_TIERS",
           "EngineMeasurement", "FAILOVER_ORDER", "PagePool",
           "PagedServeEngine", "PagesExhausted", "ReplicaPool", "Request",
           "RequestEvent", "ScheduleStats", "ServeEngine", "TierSpec",
           "batched_arrivals", "bucket_len", "lm_tiers", "paged_lm_tiers",
           "poisson_request_arrays", "poisson_requests",
           "requests_from_events"]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)
