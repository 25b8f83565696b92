"""Model-reference and source placeholder resolution.

Counterpart of ``evam_tpu/graph/template.py`` (a copy).

The reference's template expansion substitutes
``{models[alias][version][network|proc]}`` with paths under the models
directory and ``{auto_source}`` with a source element chosen per
request (reference pipelines/object_detection/person_vehicle_bike/
pipeline.json:3-4; layout reference README.md:44-52).

Here model refs stay symbolic (``alias/version``) until the engine
resolves them through the ModelRegistry; this module provides the
string-level parsing shared by the compat parser and the native loader.
"""

from __future__ import annotations

import re

_MODEL_RE = re.compile(
    r"\{models\[([^\]]+)\]\[([^\]]+)\](?:\[(network|proc|[^\]]+)\])?\}"
)

AUTO_SOURCE = "{auto_source}"


def parse_model_ref(text: str) -> tuple[str, str, str] | None:
    """Return (alias, version, field) if *text* contains a model ref."""
    m = _MODEL_RE.search(text)
    if not m:
        return None
    return m.group(1), m.group(2), m.group(3) or "network"


def model_ref_to_key(text: str) -> str | None:
    """``{models[a][v][network]}`` → ``"a/v"``; None if not a ref."""
    parsed = parse_model_ref(text)
    if parsed is None:
        return None
    alias, version, _ = parsed
    return f"{alias}/{version}"
