from repro_torch.serving.engine import EngineMeasurement
from repro_torch.serving.replica import (DEFAULT_TIERS, FAILOVER_ORDER,
                                         ReplicaPool, TierSpec)

__all__ = ["DEFAULT_TIERS", "EngineMeasurement", "FAILOVER_ORDER",
           "ReplicaPool", "TierSpec"]
