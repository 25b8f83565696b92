"""Format stages (counterpart of ``evam_tpu/stages/misc.py``).

``ConvertStage`` only: the audio stages (``AudioMixStage``,
``LevelStage``) come with port slice 5.
"""

from __future__ import annotations

from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext


class ConvertStage(Stage):
    """videoconvert / caps-filter counterpart: format negotiation is part
    of the engine's preprocess, so this validates and passes through."""

    def __init__(self, name: str, properties: dict | None = None):
        self.name = name
        self.properties = properties or {}

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        return [ctx]
