"""Model-proc files: per-model pre/post-processing descriptions.

Counterpart of ``evam_tpu/modelproc/proc.py`` (a copy, built on the
port's :class:`~evam_tpu_torch.ops.preprocess.PreprocessSpec`).

The reference attaches a model-proc JSON to each model describing
input preprocessing (color_space / resize / crop, reference
models_list/action-recognition-0001.json:3-13) and output
post-processing (converter, labels, attribute_name — same file :14-421,
and models_list/vehicle-detection-0202.json:3-10). DL Streamer's C++
elements interpret it per frame; here it compiles once into the
static :class:`~evam_tpu_torch.ops.preprocess.PreprocessSpec` (read by
the engine step) plus host-side label/attribute mappings.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from evam_tpu_torch.ops.preprocess import PreprocessSpec


@dataclass
class OutputPostproc:
    """One output converter description."""

    converter: str = "tensor_to_label"  # or tensor_to_bbox_ssd, raw
    attribute_name: str = ""
    labels: list[str] = field(default_factory=list)
    method: str = "max"  # or softmax
    layer_name: str = ""


@dataclass
class ModelProc:
    input_color_space: str = "BGR"
    input_resize: str = "stretch"
    input_crop: str = ""
    outputs: list[OutputPostproc] = field(default_factory=list)
    raw: dict[str, Any] = field(default_factory=dict)

    def preprocess_spec(self, height: int, width: int, dtype: str = "bfloat16") -> PreprocessSpec:
        resize = self.input_resize
        if resize == "aspect-ratio" and self.input_crop == "central":
            resize = "central-crop"
        elif resize not in ("stretch", "aspect-ratio"):
            resize = "stretch"
        color = "BGR" if self.input_color_space.upper() == "BGR" else "RGB"
        return PreprocessSpec(
            height=height, width=width, color_space=color, resize=resize, dtype=dtype
        )

    def labels_for(self, index: int = 0) -> list[str]:
        if index < len(self.outputs):
            return self.outputs[index].labels
        return []


def load_model_proc(path: str | Path) -> ModelProc:
    """Parse a model-proc JSON file (json_schema_version 2.x)."""
    data = json.loads(Path(path).read_text())
    proc = ModelProc(raw=data)
    for pre in data.get("input_preproc", []):
        params = pre.get("params", {})
        proc.input_color_space = params.get("color_space", proc.input_color_space)
        proc.input_resize = params.get("resize", proc.input_resize)
        proc.input_crop = params.get("crop", proc.input_crop)
    for post in data.get("output_postproc", []):
        proc.outputs.append(
            OutputPostproc(
                converter=post.get("converter", "tensor_to_label"),
                attribute_name=post.get("attribute_name", ""),
                labels=list(post.get("labels", [])),
                method=post.get("method", "max"),
                layer_name=post.get("layer_name", ""),
            )
        )
    return proc


def dump_model_proc(proc_labels: list[str], attribute_name: str = "") -> dict[str, Any]:
    """Produce a minimal model-proc dict (used by `model fetch` to
    materialize default procs alongside generated models)."""
    post: dict[str, Any] = {"labels": proc_labels}
    if attribute_name:
        post["attribute_name"] = attribute_name
        post["converter"] = "tensor_to_label"
        post["method"] = "softmax"
    return {
        "json_schema_version": "2.0.0",
        "input_preproc": [],
        "output_postproc": [post],
    }
