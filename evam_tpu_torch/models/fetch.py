"""`fetch-models`: materialize the serving model directory.

Counterpart of ``evam_tpu/models/fetch.py``, on the port's registry and
IR importer. It reads a YAML model list (the reference's schema:
model/alias/version/precision/model-proc — models_list/models.list.yml)
and produces the serving layout ``models/{alias}/{version}/
{precision}/``:

* :func:`fetch_models` exports the built-in zoo's weights (seeded
  random init: the port's numbers, not the reference's — ``jax.random``
  cannot be reproduced in torch) and writes default model-proc JSONs;
* :func:`import_ir_dir` (``--from-ir``) installs OpenVINO IR files,
  each loaded once first;
* :func:`synthesize_omz` (``--synthesize-omz``) writes OMZ-topology-
  shaped IRs (``models/ir_build.py``) — byte-equal to the reference's
  for the same arguments.

Dropping trained ``weights.msgpack`` files into the same layout
upgrades a model in place without code changes.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path

from evam_tpu_torch.modelproc.proc import dump_model_proc
from evam_tpu_torch.models.ir import load_ir
from evam_tpu_torch.models.ir_build import (
    build_aclnet_like_ir,
    build_action_decoder_like_ir,
    build_action_encoder_like_ir,
    build_attributes_like_ir,
    build_crossroad_like_ir,
)
from evam_tpu_torch.models.registry import ZOO_SPECS, ModelRegistry

log = logging.getLogger("evam_tpu_torch.models.fetch")

_ALLOWED_PRECISIONS = {"FP32", "FP16", "BF16", "INT8", "FP16-INT8", "FP32-INT8"}


class ModelListError(ValueError):
    pass


def parse_model_list(path: str | Path) -> list[dict]:
    """Parse and validate the models.list.yml schema.

    Schema mirrors reference tools/model_downloader/mdt_schema.py:7-34:
    each entry is a model name or a mapping with required ``model`` and
    optional alias/version/precision/model-proc. Implemented without a
    yaml dependency (the list format is a flat subset of YAML).
    """
    entries: list[dict] = []
    current: dict | None = None
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if line.startswith("- "):
            if current:
                entries.append(current)
            current = {}
            line = line[2:].strip()
            if line and ":" not in line:
                current["model"] = line
                continue
        elif current is None:
            raise ModelListError(f"{path}:{lineno}: expected list item")
        else:
            line = line.strip()
        if not line:
            continue
        key, _, value = line.partition(":")
        value = value.strip()
        if value.startswith("[") and value.endswith("]"):
            parsed = [v.strip() for v in value[1:-1].split(",") if v.strip()]
        else:
            parsed = value
        current[key.strip()] = parsed
    if current:
        entries.append(current)

    for e in entries:
        if "model" not in e or not e["model"]:
            raise ModelListError(f"entry missing required 'model': {e}")
        precisions = e.get("precision", ["FP32"])
        if isinstance(precisions, str):
            precisions = [precisions]
        bad = set(precisions) - _ALLOWED_PRECISIONS
        if bad:
            raise ModelListError(f"{e['model']}: invalid precisions {sorted(bad)}")
        e["precision"] = precisions
        # reference defaults: alias=model name, version=1
        # (tools/model_downloader/downloader.py:190-212)
        e.setdefault("alias", e["model"])
        e.setdefault("version", "1")
    return entries


def _zoo_key_for(entry: dict) -> str | None:
    key = f"{entry['alias']}/{entry['version']}"
    if key in ZOO_SPECS:
        return key
    for k, s in ZOO_SPECS.items():
        if s.omz_name == entry["model"]:
            return k
    return None


def fetch_models(
    model_list: str | Path,
    output: str | Path,
    force: bool = False,
    dtype: str = "float32",
) -> int:
    entries = parse_model_list(model_list)
    out_root = Path(output)
    failures = 0
    for entry in entries:
        key = _zoo_key_for(entry)
        if key is None:
            log.error("no zoo model for manifest entry %s", entry["model"])
            failures += 1
            continue
        spec = ZOO_SPECS[key]
        target = out_root / entry["alias"] / str(entry["version"])
        for precision in entry["precision"]:
            wpath = target / precision / "weights.msgpack"
            if wpath.exists() and not force:
                log.info("%s exists, skipping (use force=True)", wpath)
                continue
            # materializing weights IS the point here — random init is
            # the intended source when nothing exists yet; it is built
            # on the CPU, the card is not needed to write a file
            reg = ModelRegistry(models_dir=out_root, precision=precision,
                                dtype="bfloat16" if precision == "BF16" else dtype,
                                allow_random_weights=True, device="cpu")
            reg.save_weights(key, out_root)
            # save_weights writes under the zoo key; move if aliased
            src = out_root / key / precision / "weights.msgpack"
            if src != wpath:
                wpath.parent.mkdir(parents=True, exist_ok=True)
                src.replace(wpath)
            log.info("materialized %s", wpath)
        proc_path = target / f"{entry['model']}.json"
        if not proc_path.exists() or force:
            proc_path.parent.mkdir(parents=True, exist_ok=True)
            head_labels = dict(spec.head_labels)
            if head_labels:
                name, labels_ = next(iter(head_labels.items()))
                proc = dump_model_proc(list(labels_), attribute_name=name)
            else:
                proc = dump_model_proc(list(spec.labels))
            proc_path.write_text(json.dumps(proc, indent=2) + "\n")
    log.info("fetched %d manifest entries (%d failures)", len(entries), failures)
    return 1 if failures else 0


def import_ir_dir(
    ir_dir: str | Path,
    output: str | Path,
    alias: str | None = None,
    version: str = "1",
    precision: str = "FP32",
) -> int:
    """``fetch-models --from-ir``: install OpenVINO IR model(s) into
    the serving layout and smoke-import each one.

    ``ir_dir`` may point at a single ``model.xml`` (with sibling
    ``.bin``) or a directory tree of them (the OMZ download layout).
    Each IR is copied to ``{output}/{alias}/{version}/{precision}/``
    and loaded once through models/ir.py to fail fast on unsupported
    topologies. The serving path then picks the IR up directly
    (ModelRegistry._ir_xml_path).
    """
    src = Path(ir_dir)
    xmls = [src] if src.suffix == ".xml" else sorted(src.rglob("*.xml"))
    xmls = [x for x in xmls if x.with_suffix(".bin").exists()]
    if not xmls:
        log.error("no .xml with sibling .bin under %s", src)
        return 1
    if alias is not None and "/" in alias:
        # the registry key is {alias}/{version}; a slashed alias
        # would install at a depth _ir_xml_path never resolves (e.g.
        # for key "object_detection/person" pass --alias
        # object_detection --version person)
        log.error(
            "--alias %r must not contain '/': the serving key is "
            "{alias}/{version} — pass the second segment via --version",
            alias,
        )
        return 1
    if alias is not None and len(xmls) > 1:
        # distinct models silently sharing one alias dir would leave
        # the registry serving an arbitrary one (sorted()[0])
        log.error(
            "--alias %s with %d IR files under %s — pass a single "
            ".xml with --alias, or omit it to alias each by stem",
            alias, len(xmls), src,
        )
        return 1
    failures = 0
    seen_targets: set = set()
    for xml in xmls:
        name = alias or xml.stem
        try:
            model = load_ir(xml)
        except Exception as exc:  # noqa: BLE001 — report and continue
            log.error("cannot import %s: %s", xml, exc)
            failures += 1
            continue
        target = Path(output) / name / version / precision
        if target in seen_targets:
            # same stem at multiple tree depths (e.g. FP16/ and FP32/
            # copies in an OMZ download): the second would clobber the
            # first with different-precision weights
            log.error("duplicate IR stem %r — %s already installed; "
                      "import precisions separately with --precision",
                      name, target)
            failures += 1
            continue
        seen_targets.add(target)
        target.mkdir(parents=True, exist_ok=True)
        shutil.copy2(xml, target / xml.name)
        shutil.copy2(xml.with_suffix(".bin"), target / xml.with_suffix(".bin").name)
        log.info(
            "installed IR %s -> %s (input %s, outputs %s)",
            xml.name, target, model.input_shape, model.output_names,
        )
    return 1 if failures else 0


def synthesize_omz(
    output: str | Path,
    alias: str = "omz_like",
    version: str = "1",
    precision: str = "FP32",
    input_size: int | None = None,
    width: int | None = None,
    num_classes: int = 4,
    topology: str = "ssd",
) -> int:
    """``fetch-models --synthesize-omz``: materialize an OMZ-shaped IR
    (models/ir_build.py) into the serving layout.

    The reference's model_downloader needs network access to OMZ;
    air-gapped deployments get a real IR-backed model with the same
    topology shape instead — seeded weights, deterministic, immediately
    servable. ``topology``: "ssd" (crossroad-0078-shaped MobileNet-SSD
    detector), "attributes" (vehicle-attributes-shaped multi-head
    classifier) or "manifest" (every manifest model). Real IRs
    installed later via --from-ir simply replace the directory.
    """
    if topology == "manifest":
        return _synthesize_manifest(output, precision)

    target = Path(output) / alias / version / precision
    if topology == "attributes":
        xml, _, meta = build_attributes_like_ir(
            target, input_size=input_size or 72, width=width or 16,
        )
        note = f"heads {meta['heads']}"
    elif topology == "ssd":
        xml, _, meta = build_crossroad_like_ir(
            target, input_size=input_size or 512, width=width or 32,
            num_classes=num_classes,
        )
        note = f"{meta['anchors']} anchors"
    else:
        raise ValueError(
            f"unknown topology {topology!r} (ssd|attributes|manifest)")
    model = load_ir(xml)  # fail fast like --from-ir does
    log.info(
        "synthesized OMZ-shaped IR %s (input %s, %s) -> %s",
        alias, model.input_shape, note, target,
    )
    return 0


def _synthesize_manifest(output: str | Path, precision: str = "FP32") -> int:
    """``--synthesize-omz --topology manifest``: materialize IR-backed
    stand-ins for EVERY model in the reference manifest
    (models_list/models.list.yml — the 8 models the reference's
    model_downloader fetches from OMZ), each with its family's real
    topology shape, into the serving layout. After this, the ENTIRE
    pipeline catalog serves through the OpenVINO-IR ingestion path
    with zero network access; real `mo` output installed later via
    --from-ir simply replaces a directory.
    """
    out = Path(output)
    plans = [
        # (key, builder, kwargs) — shapes follow the zoo/OMZ specs
        ("object_detection/person_vehicle_bike", build_crossroad_like_ir,
         {"input_size": 512, "width": 32, "num_classes": 4}),
        ("object_detection/person", build_crossroad_like_ir,
         {"input_size": (320, 544), "width": 24, "num_classes": 2}),
        ("object_detection/vehicle", build_crossroad_like_ir,
         {"input_size": 512, "width": 24, "num_classes": 2}),
        ("face_detection_retail/1", build_crossroad_like_ir,
         {"input_size": 300, "width": 16, "num_classes": 2}),
        ("object_classification/vehicle_attributes",
         build_attributes_like_ir,
         {"input_size": 72, "width": 16,
          "heads": (("color", 7), ("type", 4))}),
        ("emotion_recognition/1", build_attributes_like_ir,
         {"input_size": 64, "width": 16, "heads": (("emotion", 5),)}),
        ("action_recognition/encoder", build_action_encoder_like_ir,
         {"input_size": 224, "width": 16, "embed_dim": 512}),
        ("action_recognition/decoder", build_action_decoder_like_ir,
         {"clip_len": 16, "embed_dim": 512, "hidden": 64,
          "num_classes": ZOO_SPECS["action_recognition/decoder"].num_classes}),
        ("audio_detection/environment", build_aclnet_like_ir,
         {"window": 16000, "width": 16,
          "num_classes": ZOO_SPECS["audio_detection/environment"].num_classes}),
    ]
    for key, builder, kwargs in plans:
        alias, _, version = key.partition("/")
        target = out / alias / version / precision
        xml, _, _meta = builder(target, **kwargs)
        model = load_ir(xml)  # fail fast per model
        log.info("manifest IR %s: input %s outputs %s -> %s",
                 key, model.input_shape, model.output_names, target)
    log.info(
        "synthesized %d IR models (the 8 manifest entries; the action "
        "composite is two IR dirs) under %s", len(plans), out)
    return 0
