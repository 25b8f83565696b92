"""Model registry: ``alias/version`` → built, ready-to-run model.

Counterpart of ``evam_tpu/models/registry.py``. Weights live under the
reference's directory layout, ``<models_dir>/<key>/<PRECISION>/
weights.msgpack`` in flax's msgpack format, and load through
``models/convert.py``; the two packages serve the same checkpoint.
Without weights, and with random init allowed, a module gets a seeded
init from ``torch.Generator().manual_seed(_seed_for(key))`` — the same
seed as the reference, but not the same numbers (``jax.random`` cannot
be reproduced in torch).

``EVAM_PRECISION`` (the registry's ``dtype``) keeps the reference's
meaning: ``int8`` and its aliases select precision ``INT8`` — the int8
module variants computing over bf16 tensors between layers, float
weights on disk. Weights are cast to the serving dtype, moved to the
device in channels_last layout, and then quantized once.

The port builds the SSD and classifier families and reads model-proc
files (labels, input preprocessing) as the reference does. The action
and audio families and OpenVINO IR imports come with later slices and
raise until then.
"""

from __future__ import annotations

import hashlib
import logging
import math
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn as nn

from evam_tpu_torch import slices
from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.models import labels as L
from evam_tpu_torch.modelproc import ModelProc, load_model_proc
from evam_tpu_torch.models.convert import params_from_msgpack
from evam_tpu_torch.models.zoo.classifier import MultiHeadClassifier
from evam_tpu_torch.models.zoo.layers import Conv, quantize_model
from evam_tpu_torch.models.zoo.ssd import SSDDetector
from evam_tpu_torch.ops.preprocess import PreprocessSpec

log = logging.getLogger("evam_tpu_torch.models.registry")

#: the reference's AclNet window (evam_tpu/models/zoo/aclnet.py)
WINDOW_SAMPLES = 16000

#: model families and the port slice that brings each (ROADMAP.md)
_LATER_FAMILIES = {
    "action_encoder": slices.ACTION_AUDIO,
    "action_decoder": slices.ACTION_AUDIO,
    "action": slices.ACTION_AUDIO,
    "aclnet": slices.ACTION_AUDIO,
}

_INT8_ALIASES = ("int8", "fp32-int8", "fp16-int8", "bf16-int8")


class MissingWeightsError(RuntimeError):
    """No weights on disk for a model and random init is not allowed
    (``EVAM_ALLOW_RANDOM_WEIGHTS=1`` or ``allow_random_weights=True``
    opt in)."""


def _env_allows_random() -> bool:
    return os.environ.get("EVAM_ALLOW_RANDOM_WEIGHTS", "0").lower() in (
        "1", "true", "yes", "on",
    )


@dataclass(frozen=True)
class ModelSpec:
    key: str                     # "alias/version"
    family: str                  # ssd | classifier | action | aclnet
    input_size: tuple[int, int]  # (H, W) — or (1, samples) for audio
    num_classes: int = 0
    heads: tuple[tuple[str, int], ...] = ()
    width: int = 32
    labels: tuple[str, ...] = ()
    head_labels: tuple[tuple[str, tuple[str, ...]], ...] = ()
    #: corresponding reference/OMZ model name
    omz_name: str = ""


def _spec(key, family, size, **kw):
    return ModelSpec(key=key, family=family, input_size=size, **kw)


#: Built-in zoo, the reference's ``ZOO_SPECS``.
ZOO_SPECS: dict[str, ModelSpec] = {
    s.key: s
    for s in [
        _spec(
            "object_detection/person_vehicle_bike", "ssd", (512, 512),
            num_classes=4, labels=tuple(L.PERSON_VEHICLE_BIKE),
            omz_name="person-vehicle-bike-detection-crossroad-0078",
        ),
        _spec(
            "object_detection/person", "ssd", (320, 544),
            num_classes=2, labels=tuple(L.PERSON),
            omz_name="person-detection-retail-0013",
        ),
        _spec(
            "object_detection/vehicle", "ssd", (512, 512),
            num_classes=2, labels=tuple(L.VEHICLE),
            omz_name="vehicle-detection-0202",
        ),
        _spec(
            "face_detection_retail/1", "ssd", (300, 300),
            num_classes=2, labels=tuple(L.FACE),
            omz_name="face-detection-retail-0004",
        ),
        _spec(
            "object_classification/vehicle_attributes", "classifier", (72, 72),
            heads=(("color", 7), ("type", 4)),
            head_labels=(
                ("color", tuple(L.VEHICLE_COLORS)),
                ("type", tuple(L.VEHICLE_TYPES)),
            ),
            omz_name="vehicle-attributes-recognition-barrier-0039",
        ),
        _spec(
            "emotion_recognition/1", "classifier", (64, 64),
            heads=(("emotion", 5),),
            head_labels=(("emotion", tuple(L.EMOTIONS)),),
            omz_name="emotions-recognition-retail-0003",
        ),
        _spec(
            "action_recognition/encoder", "action_encoder", (224, 224),
            num_classes=400, labels=tuple(L.ACTIONS_400),
            omz_name="action-recognition-0001-encoder",
        ),
        _spec(
            "action_recognition/decoder", "action_decoder", (224, 224),
            num_classes=400, labels=tuple(L.ACTIONS_400),
            omz_name="action-recognition-0001-decoder",
        ),
        _spec(
            "audio_detection/environment", "aclnet", (1, WINDOW_SAMPLES),
            num_classes=53, labels=tuple(L.AUDIO_EVENTS),
            omz_name="aclnet",
        ),
    ]
}


@dataclass
class LoadedModel:
    spec: ModelSpec
    module: nn.Module
    preprocess: PreprocessSpec
    device: torch.device
    model_proc: ModelProc | None = None
    labels: list[str] = field(default_factory=list)
    #: classifier head → its labels (the spec's ``head_labels``)
    head_labels: dict[str, list[str]] = field(default_factory=dict)
    anchors: np.ndarray | None = None
    #: SSD box-decode variances
    variances: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    #: True when the model emits probabilities (engine steps must not
    #: re-softmax); zoo modules emit logits
    conf_is_prob: bool = False
    #: the same per classifier head (IR imports only; zoo heads emit
    #: logits, so it stays empty)
    head_is_prob: dict[str, bool] = field(default_factory=dict)
    detector_kind: str = "ssd"
    #: weight provenance — "msgpack" (loaded from disk) or "random"
    #: (seeded init, opt-in only)
    weight_source: str = "unknown"

    @property
    def forward(self) -> Callable[[torch.Tensor], Any]:
        """batch → raw outputs (the reference's ``forward(params, batch)``
        with the params held by the module)."""
        return self.module


def build_module(spec: ModelSpec, overrides: dict[str, Any] | None = None):
    cfg = dict(overrides or {})
    width = cfg.get("width", spec.width)
    quant = bool(cfg.get("quant", False))
    if spec.family == "ssd":
        return SSDDetector(num_classes=spec.num_classes, width=width,
                           quant=quant)
    if spec.family == "classifier":
        return MultiHeadClassifier(heads=spec.heads, width=width, quant=quant)
    if spec.family in _LATER_FAMILIES:
        raise NotImplementedError(
            f"model family {spec.family!r} ({spec.key}) comes with "
            f"{_LATER_FAMILIES[spec.family]}")
    raise ValueError(f"unknown model family {spec.family!r}")


def _seed_for(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: lecun-normal kernels (truncated normal, variance
    1/fan_in) for convs and dense layers, zero biases — drawn from
    ``generator``."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Linear)):
            fan_in = m.weight[0].numel()
            # flax's truncated-normal stddev correction for the ±2σ cut
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()


class ModelRegistry:
    """Builds and caches models, resolving weights from disk.

    ``dtype`` is the serving precision (``EVAM_PRECISION``; None reads
    the environment, default ``bfloat16``); ``device`` is where the
    model runs (None → ``cuda``, which must exist)."""

    def __init__(
        self,
        models_dir: str | Path | None = None,
        precision: str = "BF16",
        dtype: str | None = None,
        input_overrides: dict[str, tuple[int, int]] | None = None,
        width_overrides: dict[str, int] | None = None,
        allow_random_weights: bool | None = None,
        device: str | torch.device | None = None,
    ):
        self.models_dir = Path(models_dir) if models_dir else None
        self.allow_random_weights = (
            _env_allows_random() if allow_random_weights is None
            else bool(allow_random_weights)
        )
        if dtype is None:
            dtype = os.environ.get("EVAM_PRECISION", "bfloat16")
        if dtype.lower() in _INT8_ALIASES:
            precision = "INT8"
            dtype = "bfloat16"
        self.precision = precision
        self.dtype = dtype
        self.device = resolve_device(device)
        self.input_overrides = input_overrides or {}
        self.width_overrides = width_overrides or {}
        self._cache: dict[str, LoadedModel] = {}

    def get(self, key: str) -> LoadedModel:
        if key not in self._cache:
            self._cache[key] = self._load(key)
        return self._cache[key]

    def keys(self) -> list[str]:
        """Model keys, as the reference lists them: the built-in zoo plus
        any on-disk OpenVINO IR dirs (``{alias}/{version}/{precision}/
        *.xml``; loading one raises until the import slice)."""
        keys = set(ZOO_SPECS)
        if self.models_dir and self.models_dir.exists():
            for xml in self.models_dir.glob("*/*/*/*.xml"):
                keys.add(f"{xml.parts[-4]}/{xml.parts[-3]}")
        return sorted(keys)

    def describe(self) -> list[dict[str, Any]]:
        """Per-model weight provenance WITHOUT loading anything — served
        by ``GET /models`` with the reference's rows and strings:
        "msgpack" (weights on disk), "ir-bin" / "ir-bin+override" (an
        OpenVINO IR on disk), "random" (seeded init, only when random
        weights are allowed) or "absent"."""
        out = []
        for key in self.keys():
            alias, _, version = key.rpartition("/")
            if key in self._cache:
                weights = self._cache[key].weight_source
            elif (xml := self._ir_xml_path(key)) is not None:
                weights = (
                    "ir-bin+override"
                    if (xml.parent / "weights.msgpack").exists()
                    else "ir-bin"
                )
            elif (spec := ZOO_SPECS.get(key)) is not None \
                    and self._weights_path(spec) is not None:
                weights = "msgpack"
            elif self.allow_random_weights:
                weights = "random"
            else:
                weights = "absent"
            out.append({"name": alias, "version": version,
                        "weights": weights,
                        "allow_random_weights": self.allow_random_weights})
        return out

    def _ir_xml_path(self, key: str) -> Path | None:
        """An OpenVINO IR under ``models/{alias}/{version}/{precision}/
        *.xml`` (the reference's layout)."""
        if not self.models_dir:
            return None
        base = self.models_dir / key
        for precision in (self.precision, "BF16", "FP32", "FP16"):
            hits = sorted((base / precision).glob("*.xml"))
            if hits:
                return hits[0]
        return None

    def _load(self, key: str) -> LoadedModel:
        if self._ir_xml_path(key) is not None:
            # the reference would serve the IR's weights: serving the
            # zoo module instead would be a silent divergence
            raise NotImplementedError(
                f"{key}: OpenVINO IR models come with {slices.MODEL_IMPORT}")
        spec = ZOO_SPECS.get(key)
        if spec is None:
            raise KeyError(
                f"unknown model '{key}' — not in the built-in zoo "
                f"(known: {sorted(ZOO_SPECS)})")
        if key in self.input_overrides:
            spec = ModelSpec(**{**spec.__dict__,
                                "input_size": self.input_overrides[key]})
        if key in self.width_overrides:
            spec = ModelSpec(**{**spec.__dict__,
                                "width": self.width_overrides[key]})
        module = build_module(
            spec, {"quant": "INT8" in self.precision.upper()})
        weight_source = self._init_or_load_params(spec, module)
        serve_dtype = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        module = module.to(device=self.device, dtype=serve_dtype,
                           memory_format=torch.channels_last)
        quantize_model(module)
        module.eval().requires_grad_(False)
        proc = self._find_model_proc(spec)
        model_labels = list(spec.labels)
        if proc and proc.labels_for(0):
            model_labels = proc.labels_for(0)
        if proc:
            preproc = proc.preprocess_spec(*spec.input_size, dtype=self.dtype)
        else:
            preproc = PreprocessSpec(
                height=spec.input_size[0], width=spec.input_size[1],
                color_space="BGR",  # OMZ-era nets are BGR-native
                dtype=self.dtype)
        return LoadedModel(
            spec=spec,
            module=module,
            preprocess=preproc,
            device=self.device,
            model_proc=proc,
            labels=model_labels,
            head_labels={k: list(v) for k, v in spec.head_labels},
            anchors=(module.anchors(spec.input_size)
                     if spec.family == "ssd" else None),
            weight_source=weight_source,
        )

    def _find_model_proc(self, spec: ModelSpec) -> ModelProc | None:
        """The first readable model-proc JSON under the model's dir, as
        the reference picks it (a bad one is logged and skipped)."""
        if not self.models_dir:
            return None
        for candidate in sorted((self.models_dir / spec.key).glob("**/*.json")):
            try:
                return load_model_proc(candidate)
            except (OSError, ValueError, TypeError, AttributeError) as exc:
                log.warning("bad model-proc %s: %s", candidate, exc)
        return None

    def _weights_path(self, spec: ModelSpec) -> Path | None:
        if not self.models_dir:
            return None
        base = self.models_dir / spec.key
        for precision in (self.precision, "BF16", "FP32", "FP16"):
            p = base / precision / "weights.msgpack"
            if p.exists():
                return p
        return None

    def _init_or_load_params(self, spec: ModelSpec, module: nn.Module) -> str:
        path = self._weights_path(spec)
        if path is None and not self.allow_random_weights:
            looked = (
                f"{self.models_dir / spec.key}/"
                f"{{{self.precision},BF16,FP32,FP16}}/weights.msgpack"
                if self.models_dir else "(no models_dir configured)"
            )
            raise MissingWeightsError(
                f"no weights found for model '{spec.key}' — looked in "
                f"{looked}. Install weights, or set "
                "EVAM_ALLOW_RANDOM_WEIGHTS=1 to explicitly serve "
                "deterministic random-init weights (benches/tests only)."
            )
        if path is not None:
            log.info("loading weights for %s from %s", spec.key, path)
            state = params_from_msgpack(path.read_bytes())
            module.load_state_dict(state, strict=True)
            return "msgpack"
        log.warning("no weights on disk for %s — seeded random init "
                    "(EVAM_ALLOW_RANDOM_WEIGHTS is set)", spec.key)
        init_params(module, torch.Generator().manual_seed(_seed_for(spec.key)))
        return "random"
