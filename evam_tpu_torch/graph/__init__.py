"""Pipeline definitions: spec, loader, parameter binding (counterpart
of ``evam_tpu/graph``)."""

from evam_tpu_torch.graph.loader import PipelineLoader
from evam_tpu_torch.graph.params import ParameterError, resolve_parameters
from evam_tpu_torch.graph.spec import PipelineSpec, StageKind, StageSpec

__all__ = [
    "StageKind",
    "StageSpec",
    "PipelineSpec",
    "PipelineLoader",
    "resolve_parameters",
    "ParameterError",
]
