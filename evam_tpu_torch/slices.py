"""The port's later slices, as named in ROADMAP.md Queue 1.

A knob, stage kind, source type, destination, route or model family
that comes with a later slice raises ``NotImplementedError`` naming
its slice from this table, never a silent fallback.
"""

TRACK_GATE_RAGGED = "port slice 4 (tracking, gating, UDFs, ragged)"
ACTION_AUDIO = "port slice 5 (action and audio)"
MODEL_IMPORT = "port slice 6 (real-model import)"
ENGINE_DEPTH = "port slice 7 (engine depth, scheduling, fleet and cold start)"
EII = "port slice 8 (EII mode)"
TRACE_STATE = "port slice 10 (tracing and stream state)"
INGEST_EGRESS = "port slice 11 (ingest and egress)"
