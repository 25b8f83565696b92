"""The control's readings: the reference in the program's place.

    python3 gpubench/tools/control.py --workload pvb_attrs.seed_sat \\
        --seeds 11 12 13 --bits 4

For each run seed, makes the cell's weights as a run does, draws as many
frames as a run compares from the cell's frame seeds, computes their
rows with the plain reference at ``--bits``-bit integer arithmetic on
the layers the configuration quantizes (4: the control for INT8; 8: the
configuration's own precision, a sanity reading; 0: float32), and
judges them exactly as a run judges the program's rows. Prints one line
a seed with the numbers and the limits. Runs on the card when there is
one, else on the CPU (``--frames`` cuts the count there).

``--fault`` plants a fault of the top-k cut or NMS in the reference put
in the program's place (float32), for the readings of a fault at the
cell's own size: ``nms_skipped`` (no suppression), ``nms_too_eager``
(an IoU threshold of 0.05), ``top_k_of_one_level`` (the top k drawn
from the first level's anchors alone), ``a_row_lost`` (each frame's
first valid row dropped after NMS, the others moved up).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpubench.harness import load, spec, weights  # noqa: E402


def control_rows(cell, ref, ref_params, seeds: np.ndarray, bits: int,
                 device, block: int = 16) -> np.ndarray:
    quant = ref.Quant(bits) if bits else None
    out = []
    for at in range(0, len(seeds), block):
        s = torch.from_numpy(seeds[at:at + block]).to(device)
        out.append(ref.serve(cell.config, ref_params, s, quant)
                   .rows.cpu().numpy())
    return np.concatenate(out)


FAULT_IOU = {"nms_skipped": 1.5, "nms_too_eager": 0.05}
FAULTS = (*FAULT_IOU, "top_k_of_one_level", "a_row_lost")


def fault_rows(cell, ref, ref_params, seeds: np.ndarray, fault: str,
               device, block: int = 16) -> np.ndarray:
    """The reference's rows with ``fault`` planted in its top-k cut or
    NMS."""
    cfg = copy.deepcopy(cell.config)
    det = cfg["detector"]
    det["iou_threshold"] = FAULT_IOU.get(fault, det["iou_threshold"])
    h, w = det["input_hw"]
    first = -(-h // 8) * -(-w // 8) * (len(det["aspect_ratios"]) + 1)
    out = []
    for at in range(0, len(seeds), block):
        s = torch.from_numpy(seeds[at:at + block]).to(device)
        wire = ref.wire_of(cfg, s)
        d = ref.detect(cfg, ref_params["detector"], wire, None)
        rows = d.rows
        if fault == "top_k_of_one_level":
            probs = d.probs.clone()
            probs[:, first:, 1:] = 0.0
            rows = ref.nms_rows(d.boxes, probs, det)
        if fault == "a_row_lost":
            lost = torch.zeros_like(rows)
            lost[..., 5] = -1.0
            lost[:, :-1] = rows[:, 1:]
            rows = torch.where((rows[:, :1, 6:7] > 0.5), lost, rows)
        if cfg.get("classifier"):
            rows = ref.classify_rows(cfg, ref_params["classifier"], wire,
                                     rows, None)
        out.append(rows.cpu().numpy())
    return np.concatenate(out)


def readings(cell, seed: int, bits: int, frames: int, device,
             fault: str | None = None):
    ref = spec.reference_module(cell.config["reference"])
    ref_params = {role: {k: v.float() for k, v in p.items()}
                  for role, (_, p) in ref.make_weights(
                      cell.config, seed, device, torch.bfloat16,
                      weights.make).items()}
    rng = np.random.default_rng(seed)
    seeds = np.array([load.frame_seed(seed, int(s), int(i)) for s, i in zip(
        rng.integers(0, 64, frames), rng.integers(0, 4096, frames))],
        np.int64)
    rows = (fault_rows(cell, ref, ref_params, seeds, fault, device) if fault
            else control_rows(cell, ref, ref_params, seeds, bits, device))
    judge = spec.judge_module(cell.bench_dir, cell.config["judge"])
    return judge.judge(cell.config, ref, ref_params, seeds, rows, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    frames = args.frames or cell.config["check"]["frames"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers, summary = readings(cell, seed, args.bits, frames, device,
                                    args.fault)
        print(json.dumps({"line": "control", "cell": cell.name, "seed": seed,
                          "bits": args.bits, "fault": args.fault,
                          "numbers": numbers,
                          "limits": cell.config["check"]["limits"],
                          **summary, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
