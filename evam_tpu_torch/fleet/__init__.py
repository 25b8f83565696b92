"""Fleet serving (``EVAM_FLEET``): per-device engine shards behind a
consistent-hash stream placer, with a mesh twin for the batch class's
big buckets (counterpart of ``evam_tpu/fleet``). The N single-device
engines live inside one process, one per device of the hub's device
list, fronted by placement and a fleet-wide admission view instead of
an external load balancer."""

from evam_tpu_torch.fleet.engine import FleetEngine, MeshStep, fleet_mode
from evam_tpu_torch.fleet.placer import ConsistentHashPlacer

__all__ = ["ConsistentHashPlacer", "FleetEngine", "MeshStep", "fleet_mode"]
