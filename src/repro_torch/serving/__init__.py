from repro_torch.serving.engine import (EngineMeasurement, PagedServeEngine,
                                       ServeEngine, bucket_len)
from repro_torch.serving.page_pool import PagePool, PagesExhausted
from repro_torch.serving.replica import (DEFAULT_TIERS, FAILOVER_ORDER,
                                         ReplicaPool, TierSpec, lm_tiers,
                                         paged_lm_tiers)
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, ScheduleStats,
                                           requests_from_events)
from repro_torch.serving.workload import (RequestEvent, batched_arrivals,
                                          poisson_request_arrays,
                                          poisson_requests)

__all__ = ["ContinuousBatchingScheduler", "DEFAULT_TIERS",
           "EngineMeasurement", "FAILOVER_ORDER", "PagePool",
           "PagedServeEngine", "PagesExhausted", "ReplicaPool", "Request",
           "RequestEvent", "ScheduleStats", "ServeEngine", "TierSpec",
           "batched_arrivals", "bucket_len", "lm_tiers", "paged_lm_tiers",
           "poisson_request_arrays", "poisson_requests",
           "requests_from_events"]
