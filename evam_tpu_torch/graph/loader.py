"""Pipeline directory loader.

Counterpart of ``evam_tpu/graph/loader.py`` (a copy).

Scans ``{pipelines_dir}/{name}/{version}/pipeline.json`` — the same
layout the reference serves from (reference pipelines/** and
eii/docker-compose.yml:51 ``PIPELINES_DIR``). Each file may be:

* native (``"type": "tpu"``) with an explicit ``stages`` list, or
* reference-compatible (``"type": "GStreamer"``) with a launch
  ``template``, parsed via :mod:`evam_tpu_torch.graph.gst_compat`.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Iterator

from evam_tpu_torch.graph import gst_compat
from evam_tpu_torch.graph.spec import PipelineSpec, StageKind, StageSpec

log = logging.getLogger("evam_tpu_torch.graph.loader")


def parse_pipeline_json(
    data: dict[str, Any], name: str, version: str
) -> PipelineSpec:
    ptype = data.get("type", "tpu").lower()
    if ptype == "gstreamer":
        stages = gst_compat.parse_template(data["template"])
    elif ptype == "tpu":
        stages = [_parse_native_stage(s) for s in data["stages"]]
    else:
        raise ValueError(f"unknown pipeline type '{data.get('type')}'")
    return PipelineSpec(
        name=name,
        version=version,
        description=data.get("description", ""),
        stages=stages,
        parameters=data.get("parameters", {}),
        raw=data,
    )


def _parse_native_stage(s: dict[str, Any]) -> StageSpec:
    kind = StageKind(s["kind"])
    return StageSpec(
        kind=kind,
        name=s.get("name", s["kind"]),
        properties=dict(s.get("properties", {})),
        model=s.get("model"),
    )


class PipelineLoader:
    """Loads and caches every pipeline under a root directory."""

    def __init__(self, pipelines_dir: str | Path):
        self.root = Path(pipelines_dir)
        self._specs: dict[tuple[str, str], PipelineSpec] = {}
        self.reload()

    def reload(self) -> None:
        self._specs.clear()
        if not self.root.exists():
            log.warning("pipelines dir %s does not exist", self.root)
            return
        for path in sorted(self.root.glob("*/*/pipeline.json")):
            version_dir = path.parent
            name_dir = version_dir.parent
            key = (name_dir.name, version_dir.name)
            try:
                data = json.loads(path.read_text())
                spec = parse_pipeline_json(data, *key)
                problems = spec.validate()
                if problems:
                    log.error("pipeline %s/%s invalid: %s", *key, problems)
                    continue
                self._specs[key] = spec
            except Exception as exc:  # noqa: BLE001 - skip broken defs, keep serving
                log.error("failed to load %s: %s", path, exc)

    def get(self, name: str, version: str) -> PipelineSpec | None:
        return self._specs.get((name, version))

    def __iter__(self) -> Iterator[PipelineSpec]:
        return iter(self._specs.values())

    def names(self) -> list[tuple[str, str]]:
        return sorted(self._specs.keys())
