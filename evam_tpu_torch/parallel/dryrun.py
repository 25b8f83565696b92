"""The multi-rank dry run (counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m evam_tpu_torch.parallel.dryrun --devices 8

The reference pins N virtual CPU devices and jits every parallel axis
over them; this spawns N gloo ranks on the CPU (``mesh.launch``) and
runs, on small shapes:

1. the dp × sp (ring) × tp trainer with 4 MoE experts on the model axis,
   one step;
2. Ulysses attention against plain attention on the same mesh;
3. one SGD step through an N-stage pipeline of transformer blocks;

then, in this process, 4. the serving path: a ``BatchEngine`` running
the fused detect+classify step over an N-entry data mesh (``MeshStep``,
one replica a mesh entry, the ladder aligned to N) at 64×64, width 8.

It prints the reference's four lines with the port's numbers. Every
part runs on the CPU: NCCL takes one GPU a rank, so the collectives
cannot run on a machine with one card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from evam_tpu_torch.parallel.mesh import (
    build_pipe_mesh,
    build_train_mesh,
    launch,
)


def _shard(x: np.ndarray, mesh) -> torch.Tensor:
    """This rank's [B/dp, T/sp, H/tp, D] block of a global array."""
    c, s = mesh.coords, mesh.shape
    b, t, h = (x.shape[i] // s[a] for i, a in enumerate(("data", "seq",
                                                         "model")))
    return torch.from_numpy(np.ascontiguousarray(
        x[c["data"] * b:(c["data"] + 1) * b, c["seq"] * t:(c["seq"] + 1) * t,
          c["model"] * h:(c["model"] + 1) * h]))


def _train_part(n: int) -> str:
    from evam_tpu_torch.parallel.train import (
        ActionTrainConfig,
        build_action_trainer,
    )

    mesh = build_train_mesh()
    dp, sp = mesh.shape["data"], mesh.shape["seq"]
    cfg = ActionTrainConfig(num_classes=8, embed_dim=32, depth=1, heads=4,
                            encoder_width=4, frame_size=(32, 32),
                            clip_len=max(4, sp), moe_experts=4)
    trainer = build_action_trainer(mesh, cfg, device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(0)
    batch = max(2, dp)
    clips = rng.integers(0, 255, (batch, cfg.clip_len, 32, 32, 3),
                         dtype=np.uint8)
    labels = rng.integers(0, cfg.num_classes, (batch,)).astype(np.int32)
    state, metrics = trainer.train_step(state, *trainer.shard_batch(clips,
                                                                    labels))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    return (f"dryrun_multichip: mesh {dict(mesh.shape)} over {n} devices "
            f"(dp x sp(ring) x tp + ep/MoE), 1 train step ok, "
            f"loss={loss:.4f}")


def _ulysses_part() -> str:
    from evam_tpu_torch.parallel.ring import plain_attention
    from evam_tpu_torch.parallel.ulysses import ulysses_attention

    mesh = build_train_mesh()
    sp = mesh.shape["seq"]
    qkv = np.random.default_rng(5).standard_normal(
        (mesh.shape["data"] * 2, 2 * sp, 4, 8)).astype(np.float32)
    local = _shard(qkv, mesh)
    uly = ulysses_attention(local, local, local, mesh, causal=True)
    full = torch.from_numpy(qkv)
    ref = _shard(plain_attention(full, full, full, causal=True).numpy(), mesh)
    err = float((uly - ref).abs().max())
    assert err <= 1e-5, f"ulysses != plain attention ({err})"
    return (f"dryrun_multichip: ulysses all-to-all SP over seq={sp} "
            f"matches reference attention")


def _pipeline_part() -> str:
    from evam_tpu_torch.models.registry import init_params
    from evam_tpu_torch.models.zoo.action import TransformerBlock
    from evam_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        stack_stage_params,
    )

    mesh = build_pipe_mesh()
    n_stages = mesh.shape["pipe"]
    block = TransformerBlock(16, 2)
    stages = []
    for s in range(n_stages):
        init_params(block, torch.Generator().manual_seed(1 + s))
        stages.append({k: v.clone() for k, v in block.state_dict().items()})
    stacked = {k: v.requires_grad_()
               for k, v in stack_stage_params(stages).items()}
    xs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (max(2, n_stages), 2, 4, 16)).astype(np.float32))

    def apply_fn(p, h):
        return torch.func.functional_call(block, p, (h,))

    def pp_loss():
        return (pipeline_apply(apply_fn, stacked, xs, mesh) ** 2).mean()

    opt = torch.optim.SGD(stacked.values(), lr=1e-2)
    pp_loss().backward()
    opt.step()
    with torch.no_grad():
        pp_val = float(pp_loss())
    assert np.isfinite(pp_val)
    return (f"dryrun_multichip: pp over {n_stages} stages "
            f"(microbatch ring), 1 sgd step ok, loss={pp_val:.4f}")


def _rank(n: int) -> list[str]:
    return [_train_part(n), _ulysses_part(), _pipeline_part()]


def _serving_part(n: int) -> str:
    from evam_tpu_torch.device import mesh_devices
    from evam_tpu_torch.engine.batcher import BatchEngine
    from evam_tpu_torch.engine.steps import (
        DETECT_FIELDS,
        build_detect_classify_step,
    )
    from evam_tpu_torch.fleet.engine import MeshStep
    from evam_tpu_torch.models.registry import ZOO_SPECS, ModelRegistry

    devices = mesh_devices("cpu", [n], ["data"], count=n)
    registry = ModelRegistry(
        dtype="float32", device="cpu", allow_random_weights=True,
        input_overrides={k: (64, 64) for k in ZOO_SPECS},
        width_overrides={k: 8 for k in ZOO_SPECS})
    det = registry.get("object_detection/person_vehicle_bike")
    cls = registry.get("object_classification/vehicle_attributes")
    head_total = sum(h for _, h in cls.spec.heads)
    step = MeshStep([build_detect_classify_step(
        det, cls, max_detections=8, roi_budget=2, wire_format="i420")
        for _ in devices], devices)
    eng = BatchEngine("dryrun-detect-classify", step, "cpu",
                      max_batch=2 * n, deadline_ms=5.0, data_size=n)
    try:
        rng = np.random.default_rng(7)
        futs = [eng.submit(frames=rng.integers(0, 255, (96, 64), np.uint8))
                for _ in range(3 * n)]  # planar i420, 64×64
        outs = [f.result(timeout=120) for f in futs]
        assert all(o.shape == (8, DETECT_FIELDS + head_total) for o in outs)
        assert eng.stats.batches < len(futs), "engine never batched"
        assert eng.stats.mean_occupancy > 0, "no occupancy recorded"
    finally:
        eng.stop()
    return (f"dryrun_multichip: serving BatchEngine sharded over "
            f"{{'data': {n}}}, {len(outs)} items in {eng.stats.batches} "
            f"batches, mean occupancy {eng.stats.mean_occupancy:.2f}")


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> list[str]:
    """Every parallel axis over ``n_devices`` gloo ranks on the CPU, then
    the serving path over an ``n_devices``-entry data mesh; prints and
    returns the four lines."""
    lines = launch(n_devices, _rank, n_devices, timeout=timeout)[0]
    for line in lines:
        print(line, flush=True)
    lines.append(_serving_part(n_devices))
    print(lines[-1], flush=True)
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="gloo ranks (the reference's virtual devices)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    dryrun_multichip(args.devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
