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

The port builds every zoo family — SSD, classifier, the action encoder
and decoder (and the fused recognizer) and AclNet — and reads
model-proc files (labels, input preprocessing) as the reference does.
The reference builds no quantized variant of the action and audio
families: under ``INT8`` they run the float module in bfloat16, here
too. Its decoder and AclNet take float32 input from their engine
steps, against which flax promotes the bfloat16 params: their weights
are rounded to the serving dtype and their arithmetic is float32 — the
port keeps such a module in float32 after the rounding.
:meth:`ModelRegistry.save_weights` writes a model's weights into the
same layout, as flax's ``to_bytes`` would.

An OpenVINO IR under ``<models_dir>/<alias>/<version>/<precision>/
*.xml`` (the reference's layout) is served in place of the zoo module
(``models/ir.py``): its family comes from the zoo alias it is
installed under (else detector or classifier from its graph), its
weights from the ``.bin`` — or from a flat ``weights.msgpack`` beside
it, which overrides them (weight source ``ir-bin+override``; a zoo
tree there is ignored with a warning) — cast to the serving dtype.
Under ``INT8`` an IR serves its float weights at the registry's dtype,
as the reference does: the int8 kernel is never launched for it.
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

from evam_tpu_torch.config.settings import fresh_settings
from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.models import labels as L
from evam_tpu_torch.modelproc import ModelProc, load_model_proc
from evam_tpu_torch.models.convert import (
    flat_from_msgpack,
    packb,
    params_from_msgpack,
    params_to_msgpack,
)
from evam_tpu_torch.models.ir import ImportedIRModel, load_ir
from evam_tpu_torch.models.zoo.aclnet import WINDOW_SAMPLES, AclNet
from evam_tpu_torch.models.zoo.action import (
    ActionDecoder,
    ActionEncoder,
    ActionRecognizer,
    _DenseGeneral,
)
from evam_tpu_torch.models.zoo.classifier import MultiHeadClassifier
from evam_tpu_torch.models.zoo.layers import Conv, quantize_model
from evam_tpu_torch.models.zoo.ssd import SSDDetector
from evam_tpu_torch.ops.preprocess import PreprocessSpec

log = logging.getLogger("evam_tpu_torch.models.registry")

#: families whose engine step feeds float32 (clips, audio windows):
#: flax computes them in float32 whatever the params' dtype
_FLOAT32_INPUT = ("action_decoder", "aclnet")

_INT8_ALIASES = ("int8", "fp32-int8", "fp16-int8", "bf16-int8")

#: families whose engine steps take one raw array from the model (the
#: action encode and decode steps, the audio step), not a head dict
_ARRAY_OUT = ("action_decoder", "action_encoder", "aclnet")


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
    #: "ssd" (loc/conf + anchors) or "yolo" (RegionYolo grid maps,
    #: decoded by ops.boxes.yolo_gather in the detect step)
    detector_kind: str = "ssd"
    #: single-array models (action decoder, AclNet): True when the graph
    #: already ends in SoftMax, so the step must not softmax again
    out_is_prob: bool = False
    #: per YOLO head: {"anchors": [[w, h], ...] in input pixels}
    yolo_specs: list = field(default_factory=list)
    #: the imported OpenVINO IR graph backing the model (models/ir.py)
    ir: ImportedIRModel | None = None
    #: weight provenance — "msgpack" (loaded from disk), "ir-bin" (the
    #: IR's .bin), "ir-bin+override" (.bin + weights.msgpack) or
    #: "random" (seeded init, opt-in only)
    weight_source: str = "unknown"

    @property
    def forward(self) -> Callable[[torch.Tensor], Any]:
        """batch → raw outputs (the reference's ``forward(params, batch)``
        with the params held by the module)."""
        return self.module


class IRForward(nn.Module):
    """The engine-facing forward of an IR model (the reference's
    ``LoadedModel._ir_forward``): the engine feeds NHWC frames, the IR
    takes NCHW (a 1-channel IR takes BT.601 luma in the delivered
    channel order); a non-image batch takes the IR's rank. A detector
    returns ``{"loc": [B, A, 4], "conf": [B, A, C]}``, a YOLO detector
    its raw grid maps, the array-output families their one output
    [B, -1], a classifier each head [B, -1]."""

    def __init__(self, ir: ImportedIRModel, family: str, num_classes: int,
                 key: str, rgb_order: bool):
        super().__init__()
        self.ir = ir
        self.family = family
        self.num_classes = num_classes
        self.key = key
        self.array_out = family in _ARRAY_OUT
        self.register_buffer("luma", torch.tensor(
            [0.299, 0.587, 0.114] if rgb_order else [0.114, 0.587, 0.299]),
            persistent=False)

    def forward(self, batch: torch.Tensor):
        ir = self.ir
        if len(ir.input_shape) == 4 and batch.dim() == 4:
            if int(ir.input_shape[1]) == 1 and batch.shape[-1] == 3:
                batch = (batch * self.luma.to(batch.dtype)).sum(
                    -1, keepdim=True)
            x = batch.permute(0, 3, 1, 2)
        else:
            x = batch.reshape((batch.shape[0],)
                              + tuple(int(d) for d in ir.input_shape[1:]))
        out = ir(x)
        if ir.detector_kind == "yolo":
            return out
        if ir.is_detector:
            b = batch.shape[0]
            return {"loc": out["loc"].reshape(b, -1, 4),
                    "conf": out["conf"].reshape(b, -1, self.num_classes)}
        if self.array_out:
            if len(out) != 1:
                raise ValueError(
                    f"{self.key}: {self.family} IR must have exactly one "
                    f"output, got {list(out)} — an auxiliary Result would "
                    "be served silently")
            sole = next(iter(out.values()))
            return sole.reshape(sole.shape[0], -1)
        return {k: v.reshape(v.shape[0], -1) for k, v in out.items()}


def build_module(spec: ModelSpec, overrides: dict[str, Any] | None = None):
    cfg = dict(overrides or {})
    width = cfg.get("width", spec.width)
    quant = bool(cfg.get("quant", False))
    if spec.family == "ssd":
        return SSDDetector(num_classes=spec.num_classes, width=width,
                           quant=quant)
    if spec.family == "classifier":
        return MultiHeadClassifier(heads=spec.heads, width=width, quant=quant)
    # no quantized variant of the action and audio families, as in the
    # reference: INT8 serves their float modules in bfloat16
    if spec.family == "action_encoder":
        return ActionEncoder(width=width)
    if spec.family == "action_decoder":
        # width scales the transformer dim (default width 32 → the
        # reference-shaped dim 512); heads=8 needs dim % 8 == 0
        return ActionDecoder(num_classes=spec.num_classes, dim=width * 16)
    if spec.family == "action":
        return ActionRecognizer(num_classes=spec.num_classes)
    if spec.family == "aclnet":
        return AclNet(num_classes=spec.num_classes, width=width)
    raise ValueError(f"unknown model family {spec.family!r}")


def _seed_for(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little")


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's defaults: lecun-normal kernels (truncated normal, variance
    1/fan_in) for convs, dense layers and attention projections, zero
    biases, unit LayerNorm scales, a normal(0.02) ``pos_embed`` — drawn
    from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Conv, nn.Linear, _DenseGeneral)):
            if isinstance(m, _DenseGeneral):
                # fan-in: the kernel's dims before the output's
                fan_in = math.prod(m.weight.shape[:m.weight.dim()
                                                  - m.bias.dim()])
            else:
                fan_in = m.weight[0].numel()
            # flax's truncated-normal stddev correction for the ±2σ cut
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        if isinstance(m, ActionDecoder):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)


class ModelRegistry:
    """Builds and caches models, resolving weights from disk.

    ``dtype`` is the serving precision (``EVAM_PRECISION``; None reads
    it through the settings, default ``bfloat16``); ``device`` is where the
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
            dtype = fresh_settings().engine.precision
        if dtype.lower() in _INT8_ALIASES:
            precision = "INT8"
            dtype = "bfloat16"
        self.precision = precision
        self.dtype = dtype
        self.device = resolve_device(device)
        self.input_overrides = input_overrides or {}
        self.width_overrides = width_overrides or {}
        self._cache: dict[str, LoadedModel] = {}

    @property
    def serve_dtype(self) -> torch.dtype:
        """The dtype weights are served (and saved) in."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def get(self, key: str) -> LoadedModel:
        if key not in self._cache:
            self._cache[key] = self._load(key)
        return self._cache[key]

    def keys(self) -> list[str]:
        """Model keys, as the reference lists them: the built-in zoo plus
        any on-disk OpenVINO IR dirs (``{alias}/{version}/{precision}/
        *.xml``)."""
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
        ir_xml = self._ir_xml_path(key)
        if ir_xml is not None:
            if "INT8" in self.precision.upper():
                log.warning(
                    "%s: INT8 precision requested but the model is "
                    "IR-backed — it serves its float weights (quantized "
                    "variants exist for zoo modules only)", key)
            return self._load_ir(key, ir_xml)
        spec = ZOO_SPECS.get(key)
        if spec is None:
            raise KeyError(
                f"unknown model '{key}' — not in the built-in zoo and no "
                f"OpenVINO IR on disk (known: {sorted(ZOO_SPECS)})")
        if key in self.input_overrides:
            spec = ModelSpec(**{**spec.__dict__,
                                "input_size": self.input_overrides[key]})
        if key in self.width_overrides:
            spec = ModelSpec(**{**spec.__dict__,
                                "width": self.width_overrides[key]})
        module = build_module(
            spec, {"quant": "INT8" in self.precision.upper()})
        weight_source = self._init_or_load_params(spec, module)
        module = module.to(device=self.device, dtype=self.serve_dtype,
                           memory_format=torch.channels_last)
        if spec.family in _FLOAT32_INPUT:
            module = module.float()  # bf16-rounded weights, float32 math
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

    def _load_ir(self, key: str, xml_path: Path) -> LoadedModel:
        """A LoadedModel from an imported OpenVINO IR: topology and
        weights from the IR, labels and heads metadata from the zoo spec
        when the key is a known alias."""
        ir = load_ir(xml_path)
        h, w = ir.input_hw
        base = ZOO_SPECS.get(key)
        if ir.is_detector:
            family = "ssd"
            num_classes = ir.num_classes or (base.num_classes if base else 2)
            heads: tuple = ()
        elif base is not None and base.family in _ARRAY_OUT:
            # installed under a temporal or audio alias: that family's
            # engine step (one raw array), e.g. the OMZ
            # action-recognition-0001 decoder's TensorIterator/LSTM IR
            family = base.family
            heads = ()
            if len(ir.output_names) != 1:
                raise ValueError(
                    f"{key}: a {family} IR must have exactly one "
                    f"output, got {ir.output_names}")
            if family == "action_encoder" or not ir.output_shapes:
                num_classes = base.num_classes  # encoder output = embedding
            else:
                # the class count of the installed IR, not the zoo's
                num_classes = int(np.prod(ir.output_shapes[0][1:]))
        else:
            family = "classifier"
            num_classes = base.num_classes if base else 0
            # each output flattens to [B, prod(rest)]: OMZ classifier
            # IRs emit [1, C, 1, 1]
            heads = tuple(
                (name, int(np.prod(shape[1:])) if len(shape) > 1 else 1)
                for name, shape in zip(ir.output_names, ir.output_shapes))
        spec = ModelSpec(
            key=key, family=family, input_size=(h, w),
            num_classes=num_classes, heads=heads,
            labels=base.labels if base else (),
            head_labels=base.head_labels if base else (),
            omz_name=base.omz_name if base else ir.name,
        )

        weight_source = "ir-bin"
        # fine-tuned weights next to the IR override the .bin tensors
        override = xml_path.parent / "weights.msgpack"
        if override.exists():
            try:
                ir.load_params(flat_from_msgpack(override.read_bytes()))
                weight_source = "ir-bin+override"
                log.info("overrode IR weights for %s from %s", key, override)
            except (ValueError, TypeError) as exc:
                # a zoo-module msgpack can share the directory: its
                # nested tree is not the IR's flat dict
                log.warning("ignoring %s (not an IR weight dict: %s) — "
                            "serving the .bin weights", override, exc)
        if self.dtype == "bfloat16":
            ir.cast_params(torch.bfloat16)

        proc = self._find_model_proc(spec)
        model_labels = list(spec.labels)
        if proc and proc.labels_for(0):
            model_labels = proc.labels_for(0)
        if (ir.detector_kind == "yolo" and model_labels
                and model_labels[0].lower().strip("_")
                not in ("background", "none")):
            # NMS label ids are 1-based (yolo_gather prepends the
            # background column); YOLO label lists are 0-based
            model_labels = ["background"] + list(model_labels)
        if proc:
            preproc = proc.preprocess_spec(h, w, dtype=self.dtype)
        else:
            preproc = PreprocessSpec(height=h, width=w, color_space="BGR",
                                     dtype=self.dtype)
        module = IRForward(ir, family, num_classes, key,
                           rgb_order=preproc.color_space.upper() == "RGB")
        module = module.to(self.device).eval().requires_grad_(False)
        probs = dict(zip(ir.output_names, ir.output_is_prob))
        return LoadedModel(
            spec=spec,
            module=module,
            preprocess=preproc,
            device=self.device,
            model_proc=proc,
            labels=model_labels,
            head_labels={k: list(v) for k, v in spec.head_labels},
            anchors=ir.anchors,
            variances=ir.variances,
            conf_is_prob=probs.get("conf", False),
            head_is_prob=probs,
            detector_kind=ir.detector_kind,
            out_is_prob=bool(ir.output_is_prob and ir.output_is_prob[0]),
            yolo_specs=list(ir.yolo_specs),
            ir=ir,
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

    def save_weights(self, key: str, out_dir: str | Path | None = None) -> Path:
        """Write the model's current weights into the models-dir layout,
        ``<root>/<key>/<precision>/weights.msgpack``, as the reference's
        ``save_weights`` does: the bytes flax's ``to_bytes`` writes for
        the same params tree (``models/convert.py``). An IR model writes
        its flat weight dict — in its own order, or sorted when served in
        bfloat16, as the reference's cast re-sorts it."""
        model = self.get(key)
        root = Path(out_dir) if out_dir else self.models_dir
        if root is None:
            raise ValueError("no models_dir to save into")
        path = root / key / self.precision / "weights.msgpack"
        path.parent.mkdir(parents=True, exist_ok=True)
        if model.ir is not None:
            flat = model.ir.params
            if self.dtype == "bfloat16":
                flat = dict(sorted(flat.items()))
            path.write_bytes(packb(flat))
            return path
        state = {k: v.to(self.serve_dtype) if v.is_floating_point() else v
                 for k, v in model.module.state_dict().items()}
        path.write_bytes(params_to_msgpack(state))
        return path
