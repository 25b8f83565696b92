"""evam_tpu_torch command line: serve / list / fetch-models.

Counterpart of ``evam_tpu/cli/main.py``:

    python -m evam_tpu_torch.cli.main serve   # REST on REST_PORT (EVA)
    python -m evam_tpu_torch.cli.main list    # pipelines and models

``serve`` runs on the card unless ``EVAM_PLATFORM=cpu`` asks for the
CPU, and raises without a card. ``--mode EII`` (or ``RUN_MODE=EII``)
and ``fetch-models`` raise, naming the slice that brings them.
"""

from __future__ import annotations

import argparse
import json
import sys

from evam_tpu_torch import slices
from evam_tpu_torch.config import get_settings


def cmd_list(args) -> int:
    from evam_tpu_torch.graph import PipelineLoader
    from evam_tpu_torch.models.registry import ModelRegistry

    settings = get_settings()
    loader = PipelineLoader(settings.pipelines_dir)
    # the model list needs no device: the registry builds nothing here
    models = ModelRegistry(settings.models_dir, device="cpu").keys()
    print(json.dumps(
        {
            "pipelines": [f"{n}/{v}" for n, v in loader.names()],
            "models": models,
        },
        indent=2,
    ))
    return 0


def cmd_fetch_models(args) -> int:
    raise NotImplementedError(f"fetch-models comes with {slices.MODEL_IMPORT}")


def cmd_serve(args) -> int:
    settings = get_settings()
    mode = (args.mode or settings.run_mode).upper()
    if mode == "EII":
        raise NotImplementedError(f"EII mode comes with {slices.EII}")
    from evam_tpu_torch.server.app import run_server

    return run_server(settings)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="evam-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="start the serving frontend")
    s.add_argument("--mode", choices=["EVA", "EII", "eva", "eii"], default=None)
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("fetch-models", help="materialize the model directory")
    f.set_defaults(fn=cmd_fetch_models)

    ls = sub.add_parser("list", help="list pipelines and models")
    ls.set_defaults(fn=cmd_list)
    return p


def main(argv: list[str] | None = None) -> int:
    from evam_tpu_torch.obs import configure_logging

    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        settings = get_settings()
        configure_logging(settings.log_level.upper(), settings.dev_mode)
        return args.fn(args)
    except NotImplementedError as exc:
        # a knob, mode or command of a later slice: say which, no trace
        print(f"{parser.prog}: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
