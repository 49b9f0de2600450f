from repro_torch.data.traffic import (TrafficDataset, continual_split,
                                      generate, inject_drift,
                                      select_fl_sensors, windows_for_sensor)

__all__ = ["TrafficDataset", "continual_split", "generate",
           "inject_drift", "select_fl_sensors", "windows_for_sensor"]
