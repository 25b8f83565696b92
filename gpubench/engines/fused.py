"""The fused detect+classify engine, as the fused stage builds it.

``EngineHub.fused_engine`` with the keyword arguments
``stages/infer.py`` ``FusedDetectClassifyStage`` passes: its ROI
budget, the engine's score floor, the label ids of the configuration's
``object_class`` among the detector's labels, and the wire size its
seeds are made at.
"""


def build(hub, config: dict):
    det, cls = config["detector"], config["classifier"]
    labels = hub.model(det["key"]).labels
    allowed = tuple(i for i, name in enumerate(labels)
                    if name == cls["object_class"])
    return hub.fused_engine(
        det["key"], cls["key"], None,
        roi_budget=cls["roi_budget"],
        score_threshold=det["score_threshold"],
        allowed_label_ids=allowed,
        synth_wire_hw=tuple(config["wire"]["frame_hw"]))
