"""evamlint over ``evam_tpu_torch``: project-invariant static analysis
for the port's threaded serving stack (counterpart of
``evam_tpu/analysis/``, with the same five passes, rules, allowlist
discipline, CLI and exit codes).

The engine's correctness rests on hand-maintained invariants that
break by hand: an unlocked ``+=`` on a counter two threads bump, stale
queue gauges on a wedged engine, per-batch ``os.environ`` reads on a
dispatch thread, an import knot between two packages, and ``EVAM_*``
knobs re-plumbed across settings, compose, helm and docs. Each pass
machine-checks one of those bug classes:

- ``locks``     — mutations of declared thread-shared attributes must
                  happen under the declared lock (``SHARED_UNDER`` map
                  or ``@locked_by`` decorator; see ``annotations.py``).
- ``hotloop``   — no env reads, file I/O, ``time.sleep`` or metric
                  registration inside dispatcher/launcher/completer/
                  watchdog loop bodies.
- ``knobs``     — every ``EVAM_*`` key read by ``config/settings.py``
                  (plus ``obs.faults.ENV_KEYS``) is plumbed through
                  compose, helm values, the helm env block and README;
                  no ``EVAM_*`` env read outside settings + faults.
- ``contracts`` — metric names/label sets match ``obs.metrics.
                  METRIC_SPECS``; the stage-name list is consistent
                  across ringbuf/admission/tests; the checkpoint
                  schema is pinned; bench serve-line keys match the
                  test pins once the port's bench exists.
- ``imports``   — no package-level import cycles.

Run ``python -m evam_tpu_torch.analysis``: exit 0 clean, 1 findings
(or stale allowlist entries), 2 analyzer or allowlist malfunction.
Suppressions live in ``analysis/allowlist.toml`` — one entry per
finding, each with a written justification. The lock-discipline
section of the allowlist is required to stay empty.

The analyzer reads the code it checks as text and ASTs: it imports
nothing of the package it lints, nothing of ``evam_tpu``, and no
``torch``, so it runs anywhere.
"""

from .core import Finding, Allowlist, repo_root, run_passes, PASS_IDS
from .annotations import locked_by

__all__ = [
    "Finding", "Allowlist", "repo_root", "run_passes", "PASS_IDS",
    "locked_by",
]
