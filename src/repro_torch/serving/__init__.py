from repro_torch.serving.engine import (EngineMeasurement, PagedServeEngine,
                                       ServeEngine, bucket_len)
from repro_torch.serving.page_pool import PagePool, PagesExhausted
from repro_torch.serving.replica import (DEFAULT_TIERS, FAILOVER_ORDER,
                                         ReplicaPool, TierSpec, lm_tiers,
                                         paged_lm_tiers)

__all__ = ["DEFAULT_TIERS", "EngineMeasurement", "FAILOVER_ORDER",
           "PagePool", "PagedServeEngine", "PagesExhausted", "ReplicaPool",
           "ServeEngine", "TierSpec", "bucket_len", "lm_tiers",
           "paged_lm_tiers"]
