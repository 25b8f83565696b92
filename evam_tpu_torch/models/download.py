"""Network model acquisition (``fetch-models --download``).

Counterpart of ``evam_tpu/models/download.py``, the code ported as it
is, on the port's IR importer. The reference's downloader shells out to
OMZ ``omz_downloader`` + ``omz_converter`` (+ ``mo``) and then resolves
model-proc/label collateral; here:

* **validate** the YAML model list against the same jsonschema the
  reference uses (``mdt_schema.py:7-34``, Draft-7, string-or-object
  entries, ``additionalProperties: False``);
* **download** IR artifacts (``.xml``/``.bin``) per precision through a
  pluggable :class:`Transport` — the OMZ storage layout
  ``{base}/{model}/{precision}/{model}.xml`` — into the serving layout
  ``{output}/models/{alias}/{version}/{precision}/``;
* **convert** = import the IR through :mod:`evam_tpu_torch.models.ir`
  and fail the install if it does not load — the counterpart of the
  ``omz_converter`` step;
* **collateral**: explicit ``model-proc``/``labels`` paths (relative to
  the model list, ``downloader.py:195-204``) are copied in; otherwise
  the model-proc is fetched from ``{proc_base}/{model}.json`` like the
  reference's DL-Streamer-repo fallback (``downloader.py:115-135``).

The default :class:`UrlTransport` fetches over the network; tests
inject an in-memory transport. ``yaml`` and ``jsonschema`` are imported
when the download runs: without them ``--download`` fails naming the
package, as the reference's does.
"""

from __future__ import annotations

import json
import logging
import shutil
from dataclasses import dataclass, field
from pathlib import Path
from typing import Protocol

from evam_tpu_torch.models.fetch import _ALLOWED_PRECISIONS
from evam_tpu_torch.models.ir import load_ir

log = logging.getLogger("evam_tpu_torch.models.download")

#: Same shape as the reference's schema (its mdt_schema.py), with BF16
#: among the precisions. The enum comes from fetch._ALLOWED_PRECISIONS
#: so the two fetch-models paths cannot drift on what a valid
#: precision is.
MODEL_LIST_SCHEMA = {
    "type": "array",
    "items": {
        "oneOf": [
            {
                "type": "object",
                "properties": {
                    "model": {"type": "string"},
                    "alias": {"type": "string"},
                    "version": {"type": ["string", "integer"]},
                    "precision": {
                        "type": "array",
                        "items": {"enum": sorted(_ALLOWED_PRECISIONS)},
                    },
                    "model-proc": {"type": "string"},
                    "labels": {"type": "string"},
                },
                "required": ["model"],
                "additionalProperties": False,
            },
            {"type": "string"},
        ]
    },
}

#: Default artifact roots (the OMZ storage layout). Overridable for
#: mirrors / internal registries.
DEFAULT_BASE_URL = (
    "https://storage.openvinotoolkit.org/repositories/open_model_zoo"
    "/2022.1/models_bin/3"
)
DEFAULT_PROC_BASE_URL = (
    "https://raw.githubusercontent.com/openvinotoolkit/dlstreamer_gst"
    "/master/samples/model_proc"
)


class DownloadError(RuntimeError):
    pass


class Transport(Protocol):
    """Fetches one URL to bytes. Implementations: :class:`UrlTransport`
    (stdlib urllib, production), dict-backed mocks (tests)."""

    def fetch(self, url: str) -> bytes: ...


class UrlTransport:
    """stdlib-urllib transport (no requests dependency needed)."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s

    def fetch(self, url: str) -> bytes:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=self.timeout_s) as resp:
                return resp.read()
        except urllib.error.URLError as exc:
            raise DownloadError(f"fetch failed: {url}: {exc}") from exc


def validate_model_list(data: object) -> list:
    """jsonschema validation, same library+draft as the reference
    (``downloader.py:60-68`` Draft7Validator)."""
    try:
        import jsonschema
    except ImportError as exc:
        raise DownloadError(
            "the --download path needs jsonschema (pip install "
            "jsonschema)") from exc

    validator = jsonschema.Draft7Validator(
        MODEL_LIST_SCHEMA, format_checker=jsonschema.FormatChecker())
    errors = sorted(validator.iter_errors(data), key=lambda e: e.path)
    if errors:
        detail = "; ".join(
            f"{list(e.path)}: {e.message}" for e in errors[:5])
        raise DownloadError(f"model list failed schema validation: {detail}")
    assert isinstance(data, list)
    return data


def load_model_list(path: str | Path) -> list:
    try:
        import yaml
    except ImportError as exc:
        raise DownloadError(
            "the --download path needs pyyaml (pip install "
            "pyyaml)") from exc

    try:
        data = yaml.safe_load(Path(path).read_text())
    except yaml.YAMLError as exc:
        raise DownloadError(f"malformed model list {path}: {exc}") from exc
    return validate_model_list(data)


@dataclass
class ModelEntry:
    """One resolved model-list entry (reference
    ``downloader.py:190-212`` ``_get_model_properties``)."""

    model: str
    alias: str
    version: str
    precisions: list[str]
    model_proc: Path | None = None
    labels: Path | None = None

    @classmethod
    def resolve(cls, raw: object, list_path: Path) -> "ModelEntry":
        if isinstance(raw, str):
            raw = {"model": raw}
        assert isinstance(raw, dict)
        model = raw["model"]
        proc = raw.get("model-proc")
        labels = raw.get("labels")
        base = list_path.resolve().parent
        return cls(
            model=model,
            alias=raw.get("alias", model),
            version=str(raw.get("version", 1)),
            precisions=list(raw.get("precision") or ["FP32"]),
            # collateral paths are relative to the model list file
            model_proc=(base / proc) if proc else None,
            labels=(base / labels) if labels else None,
        )


@dataclass
class DownloadReport:
    installed: list[str] = field(default_factory=list)
    skipped: list[str] = field(default_factory=list)
    failed: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failed


def _install_ir(transport: Transport, base_url: str, entry: ModelEntry,
                precision: str, target: Path) -> None:
    """Fetch {base}/{model}/{precision}/{model}.{xml,bin} and verify the
    IR loads through the importer before declaring it installed."""
    dest = target / precision
    dest.mkdir(parents=True, exist_ok=True)
    stem = entry.model
    for ext in ("xml", "bin"):
        url = f"{base_url}/{stem}/{precision}/{stem}.{ext}"
        blob = transport.fetch(url)
        (dest / f"{stem}.{ext}").write_bytes(blob)
        log.info("downloaded %s (%d bytes)", url, len(blob))
    # "convert": importing the IR; a broken artifact fails HERE, not
    # at the first serving request
    load_ir(dest / f"{stem}.xml")


def _install_model_proc(transport: Transport, proc_base_url: str,
                        entry: ModelEntry, target: Path) -> None:
    """Explicit model-proc path wins; else fetch from the proc repo
    (reference ``downloader.py:115-135``); a missing remote proc is a
    warning, not an error — same as the reference's WARNING path."""
    if entry.model_proc is not None:
        if not entry.model_proc.is_file():
            # reference exits on specified-but-missing collateral
            # (downloader.py:268-271)
            raise DownloadError(
                f"model-proc specified but not found: {entry.model_proc}")
        shutil.copy(entry.model_proc, target / f"{entry.model}.json")
        return
    url = f"{proc_base_url}/{entry.model}.json"
    try:
        blob = transport.fetch(url)
    except DownloadError:
        log.warning("model-proc not found for %s at %s", entry.model, url)
        return
    try:  # same install-time check the IR gets: a mirror's HTML error
        # page must not land on disk as {model}.json
        json.loads(blob)
    except ValueError as exc:
        raise DownloadError(
            f"model-proc at {url} is not JSON: {exc}") from exc
    (target / f"{entry.model}.json").write_bytes(blob)


def download_models(
    model_list: str | Path,
    output: str | Path,
    transport: Transport | None = None,
    base_url: str = DEFAULT_BASE_URL,
    proc_base_url: str = DEFAULT_PROC_BASE_URL,
    force: bool = False,
) -> DownloadReport:
    """Validate → download → import-check → collateral, per entry.

    Mirrors reference ``download_and_convert_models``
    (``downloader.py:275-296``): models land under
    ``{output}/{alias}/{version}/{precision}/`` — ``output`` IS the
    registry's models_dir, same convention as ``fetch_models`` /
    ``import_ir_dir`` (the reference nests an extra ``models/``
    because its output root is the workspace, not the model dir).
    An existing target dir is skipped unless ``force``; a failing
    entry stops that entry but not the run (the report carries the
    failure — unlike the reference's sys.exit(1), a partial fleet
    install is recoverable).
    """
    transport = transport or UrlTransport()
    list_path = Path(model_list)
    entries = [ModelEntry.resolve(raw, list_path)
               for raw in load_model_list(list_path)]
    target_root = Path(output)
    target_root.mkdir(parents=True, exist_ok=True)
    report = DownloadReport()
    for entry in entries:
        target = target_root / entry.alias / entry.version
        if target.is_dir() and not force:
            log.info("model directory %s exists - skipping", target)
            report.skipped.append(entry.model)
            continue
        try:
            if target.is_dir():
                shutil.rmtree(target)
            target.mkdir(parents=True)
            for precision in entry.precisions:
                _install_ir(transport, base_url, entry, precision, target)
            _install_model_proc(transport, proc_base_url, entry, target)
            if entry.labels is not None:
                if not entry.labels.is_file():
                    raise DownloadError(
                        f"labels specified but not found: {entry.labels}")
                shutil.copy(entry.labels, target)
        except Exception as exc:  # noqa: BLE001 — a corrupt artifact
            # can surface from anywhere in the IR importer (ParseError,
            # KeyError on unresolved edges, ValueError...); ANY failure
            # must remove the partial install, or the next run would
            # skip it as already-installed
            log.error("entry %s failed: %s: %s",
                      entry.model, type(exc).__name__, exc)
            shutil.rmtree(target, ignore_errors=True)
            try:  # prune the alias dir if this was its only version
                target.parent.rmdir()
            except OSError:
                pass
            report.failed.append(entry.model)
            continue
        report.installed.append(entry.model)
    return report
