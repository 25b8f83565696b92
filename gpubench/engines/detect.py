"""The detect engine, as the detect stage builds it.

``EngineHub.engine("detect", ...)`` with the keyword arguments
``stages/infer.py`` ``DetectStage`` passes: the engine's score floor
and the wire size its seeds are made at.
"""


def build(hub, config: dict):
    det = config["detector"]
    return hub.engine("detect", det["key"], None,
                      score_threshold=det["score_threshold"],
                      synth_wire_hw=tuple(config["wire"]["frame_hw"]))
