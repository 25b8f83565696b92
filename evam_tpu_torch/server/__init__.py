"""REST serving layer (counterpart of ``evam_tpu/server``)."""

from evam_tpu_torch.server.instance import InstanceState, StreamInstance
from evam_tpu_torch.server.registry import PipelineRegistry

__all__ = ["InstanceState", "PipelineRegistry", "StreamInstance"]
