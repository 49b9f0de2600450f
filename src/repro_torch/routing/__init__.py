from repro_torch.routing.latency import CalibratedLatencyModel, LatencyModel
from repro_torch.routing.rules import EdgeState, RouteDecision, route_request
from repro_torch.routing.simulator import (RequestLog, SimConfig,
                                           compare_methods, simulate)

__all__ = ["CalibratedLatencyModel", "LatencyModel", "EdgeState",
           "RouteDecision", "route_request", "RequestLog", "SimConfig",
           "compare_methods", "simulate"]
