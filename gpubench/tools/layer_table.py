"""Print a person-vehicle-bike configuration's frozen layer table.

    python3 gpubench/tools/layer_table.py gpubench/configs/pvb_attrs_int8.json

Walks the reference's layer lists (``reference/pvb.py``) at the
configuration's input sizes and prints one JSON row a layer: its
model, kind, precision, channels, kernel, stride, groups, output grid
and whether it runs once a frame or once an ROI. The table is written
into the configuration file once and never recomputed by a run, so the
operation counts stay fixed whatever later code does.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from gpubench.reference import pvb  # noqa: E402


def _row(model, layer, in_hw, per):
    s = layer["stride"]
    out_hw = [-(-in_hw[0] // s), -(-in_hw[1] // s)]
    shape = layer["shape"]
    dense = len(shape) == 2
    return {
        "name": f"{model}.{layer['name']}", "model": model,
        "kind": "dense" if dense else "conv",
        "precision": "int8" if layer["quant"] else "bf16",
        "cin": shape[1] * (1 if dense else layer["groups"]),
        "cout": shape[0], "k": 1 if dense else shape[2], "stride": s,
        "groups": layer["groups"], "out_hw": [1, 1] if dense else out_hw,
        "per": per,
    }, out_hw


def detector_rows(det: dict) -> list[dict]:
    rows, feats = [], []
    hw = list(det["input_hw"])
    heads = []
    for layer in pvb.detector_layers(det):
        name = layer["name"]
        if name.startswith("SSDHead_"):
            heads.append(layer)
            continue
        if name.startswith("Backbone_0.ConvBlock_") and not name.startswith(
                "Backbone_0.ConvBlock_0") and int(name.split("_")[2][0]) % 2:
            hw = feats[-1]  # an extra level starts from the last feature
        row, hw = _row("detector", layer, hw, "frame")
        rows.append(row)
        if name in ("Backbone_0.SeparableConv_3.Conv_1",
                    "Backbone_0.SeparableConv_5.Conv_1",
                    "Backbone_0.SeparableConv_7.Conv_1") or (
                name.startswith("Backbone_0.ConvBlock_")
                and name != "Backbone_0.ConvBlock_0.Conv_0"
                and int(name.split("_")[2][0]) % 2 == 0):
            feats.append(hw)
    for layer in heads:
        level = int(layer["name"].split("_")[1].split(".")[0])
        rows.append(_row("detector", layer, feats[level], "frame")[0])
    return rows


def classifier_rows(cls: dict) -> list[dict]:
    rows, hw = [], list(cls["input_hw"])
    for layer in pvb.classifier_layers(cls["width"], cls["heads"]):
        row, hw = _row("classifier", layer, hw, "roi")
        rows.append(row)
    return rows


def main(path: str) -> None:
    cfg = json.loads(Path(path).read_text())
    rows = detector_rows(cfg["detector"])
    if cfg.get("classifier"):
        rows += classifier_rows(cfg["classifier"])
    print(json.dumps(rows))


if __name__ == "__main__":
    main(sys.argv[1])
