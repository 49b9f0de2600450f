from repro_torch.orchestration.controller import Deployment, LearningController
from repro_torch.orchestration.gpo import (DeviceNode, EdgeNode, Inventory,
                                     random_inventory)

__all__ = ["Deployment", "LearningController", "DeviceNode", "EdgeNode",
           "Inventory", "random_inventory"]
