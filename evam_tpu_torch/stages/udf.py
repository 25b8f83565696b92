"""User-defined function stage (gvapython counterpart).

Counterpart of ``evam_tpu/stages/udf.py``. A stage's ``module``,
``class`` and JSON ``kwarg`` name the function:

* a class with ``__init__(**kwarg)`` and
  ``process_frame(ctx: FrameContext) -> bool | None`` — returning
  False drops the frame;
* or a module-level ``process_frame(ctx)`` when no class is given.

Module names resolve as in the reference, with one difference: the
port never imports the reference package. The shared pipeline files
name the built-in extensions ``evam_tpu.extensions.<x>``, and the
reference's container paths ``/home/pipeline-server/extensions/<x>.py``
(with ``gva_event_convert`` for ``event_convert``); both resolve to
``evam_tpu_torch.extensions.<x>``. Any other ``evam_tpu`` module
raises ``ImportError`` naming it. A user's own module or ``.py`` path
imports as it is.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import logging
import sys
from pathlib import Path
from types import ModuleType

from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.context import FrameContext

log = logging.getLogger("evam_tpu_torch.stages.udf")

#: where the reference's container mounts its stock extensions
_REFERENCE_EXT_PREFIX = "/home/pipeline-server/extensions/"
#: stems of those files that differ from the built-in module's name
_REFERENCE_EXT_ALIASES = {"gva_event_convert": "event_convert"}
_REFERENCE_PKG = "evam_tpu"
_BUILTIN_EXT = "evam_tpu_torch.extensions"


def _import_builtin_extension(name: str, named_as: str) -> ModuleType:
    try:
        return importlib.import_module(f"{_BUILTIN_EXT}.{name}")
    except ModuleNotFoundError:
        raise ImportError(
            f"UDF module {named_as!r} has no built-in counterpart "
            f"{_BUILTIN_EXT}.{name}") from None


def resolve_module(module_name: str) -> ModuleType:
    """The module a UDF stage's ``module`` property names."""
    if (module_name.startswith(_REFERENCE_EXT_PREFIX)
            and not Path(module_name).exists()):
        # a real file at that path (mounted, as in the reference's
        # container) wins over the built-in mapping
        stem = Path(module_name).stem
        return _import_builtin_extension(
            _REFERENCE_EXT_ALIASES.get(stem, stem), module_name)
    if module_name.endswith(".py"):
        return _import_from_path(module_name)
    top, _, rest = module_name.partition(".")
    if top == _REFERENCE_PKG:
        ext, _, name = rest.partition(".")
        if ext != "extensions" or not name:
            raise ImportError(
                f"UDF module {module_name!r} is part of the reference "
                f"package {_REFERENCE_PKG}, which the port does not import")
        return _import_builtin_extension(name, module_name)
    return importlib.import_module(module_name)


class UdfStage(Stage):
    def __init__(self, name: str, properties: dict):
        self.name = name
        module_name = properties.get("module")
        if not module_name:
            raise ValueError(f"udf stage '{name}' needs a 'module' property")
        module = resolve_module(module_name)
        class_name = properties.get("class")
        kwarg = properties.get("kwarg", {}) or {}
        if class_name:
            self._impl = getattr(module, class_name)(**kwarg)
            self._fn = self._impl.process_frame
        else:
            self._impl = None
            self._fn = module.process_frame

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        try:
            keep = self._fn(ctx)
        except Exception:  # noqa: BLE001 — a broken UDF must not kill the stream
            log.exception("udf %s failed on frame %d", self.name, ctx.seq)
            return [ctx]
        return [] if keep is False else [ctx]


def _import_from_path(path: str) -> ModuleType:
    """Import a ``.py`` file under a name unique to its path, so files
    of one stem in two directories never collide."""
    p = Path(path).resolve()
    name = f"evam_udf_{p.stem}_{hashlib.sha1(str(p).encode()).hexdigest()[:8]}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, p)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load UDF from {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module
