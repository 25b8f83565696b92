"""``{env[VAR]}`` interpolation used by pipeline parameter defaults.

Counterpart of ``evam_tpu/config/interpolate.py`` (a copy). The
reference interpolates environment variables into pipeline JSON
default values, e.g. ``"default": "{env[DETECTION_DEVICE]}"``
(reference pipelines/object_detection/person_vehicle_bike/pipeline.json:24).
"""

from __future__ import annotations

import os
import re
from typing import Any

_ENV_RE = re.compile(r"\{env\[([A-Za-z_][A-Za-z0-9_]*)\]\}")


def interpolate_env(value: str, env: dict[str, str] | None = None) -> str:
    """Substitute every ``{env[VAR]}`` occurrence in *value*.

    Unset variables resolve to the empty string (the reference's
    behavior is to rely on compose-provided defaults; empty lets the
    caller fall back to service settings).
    """
    environ = os.environ if env is None else env
    return _ENV_RE.sub(lambda m: environ.get(m.group(1), ""), value)


def interpolate_tree(tree: Any, env: dict[str, str] | None = None) -> Any:
    """Recursively interpolate env refs through dicts/lists/strings."""
    if isinstance(tree, str):
        return interpolate_env(tree, env)
    if isinstance(tree, dict):
        return {k: interpolate_tree(v, env) for k, v in tree.items()}
    if isinstance(tree, list):
        return [interpolate_tree(v, env) for v in tree]
    return tree
