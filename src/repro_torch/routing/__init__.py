from repro_torch.routing.latency import CalibratedLatencyModel, LatencyModel

__all__ = ["CalibratedLatencyModel", "LatencyModel"]
