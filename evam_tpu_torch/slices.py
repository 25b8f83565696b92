"""The port's later slices, as named in ROADMAP.md Queue 1.

A knob, stage kind, source type, destination, route, model family or
module option that comes with a later slice raises
``NotImplementedError`` naming its slice from this table, never a
silent fallback.
"""

ENGINE_DEPTH = "port slice 7 (the AOT cache)"
PARALLEL = "port slice 9 (frozen parallel and training code)"
INGEST_EGRESS = "port slice 11 (ingest and egress)"
