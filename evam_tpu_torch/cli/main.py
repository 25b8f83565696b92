"""evam_tpu_torch command line: serve / list / fetch-models.

Counterpart of ``evam_tpu/cli/main.py``:

    python -m evam_tpu_torch.cli.main serve          # REST on REST_PORT (EVA)
    python -m evam_tpu_torch.cli.main list           # pipelines and models
    python -m evam_tpu_torch.cli.main fetch-models   # the models dir

``serve`` runs on the card unless ``EVAM_PLATFORM=cpu`` asks for the
CPU, and raises without a card. ``--mode EII`` (or ``RUN_MODE=EII``)
runs the headless EII service instead of REST (``eii/manager.py``:
config from ``EVAM_EII_CONFIG`` or etcd, results on the message bus),
on the same device. ``fetch-models`` keeps the
reference's modes, flags and exit codes: the zoo export (default),
``--from-ir``, ``--synthesize-omz [--topology ssd|attributes|
manifest]`` and ``--download`` (mutually exclusive: 2); it builds
nothing on the card.
"""

from __future__ import annotations

import argparse
import json
import sys

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
    modes = [m for m, on in [("--download", args.download),
                             ("--from-ir", bool(args.from_ir)),
                             ("--synthesize-omz", bool(args.synthesize_omz))]
             if on]
    if len(modes) > 1:
        print(f"fetch-models: {' and '.join(modes)} are mutually "
              "exclusive", file=sys.stderr)
        return 2
    if args.download:
        from evam_tpu_torch.models import download as dl

        try:
            report = dl.download_models(
                model_list=args.model_list, output=args.output,
                base_url=args.base_url or dl.DEFAULT_BASE_URL,
                proc_base_url=args.proc_base_url or dl.DEFAULT_PROC_BASE_URL,
                force=args.force,
            )
        except dl.DownloadError as exc:
            print(f"fetch-models --download: {exc}", file=sys.stderr)
            return 1
        print(f"installed={report.installed} skipped={report.skipped} "
              f"failed={report.failed}")
        return 0 if report.ok else 1
    if args.synthesize_omz:
        from evam_tpu_torch.models.fetch import synthesize_omz

        return synthesize_omz(
            args.output, alias=args.synthesize_omz, version=args.version,
            precision=args.precision, input_size=args.size,
            topology=args.topology,
        )
    if args.from_ir:
        from evam_tpu_torch.models.fetch import import_ir_dir

        return import_ir_dir(
            args.from_ir, args.output,
            alias=args.alias, version=args.version, precision=args.precision,
        )
    from evam_tpu_torch.models.fetch import fetch_models

    return fetch_models(
        model_list=args.model_list, output=args.output, force=args.force
    )


def cmd_serve(args) -> int:
    settings = get_settings()
    mode = (args.mode or settings.run_mode).upper()
    if mode == "EII":
        from evam_tpu_torch.eii.manager import run_eii_service

        return run_eii_service(settings)
    from evam_tpu_torch.server.app import run_server

    return run_server(settings)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="evam-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("serve", help="start the serving frontend")
    s.add_argument("--mode", choices=["EVA", "EII", "eva", "eii"], default=None)
    s.set_defaults(fn=cmd_serve)

    f = sub.add_parser("fetch-models", help="materialize the model directory")
    f.add_argument("--model-list", default="models_list/models.list.yml")
    f.add_argument("--output", default="models")
    f.add_argument("--force", action="store_true")
    f.add_argument("--download", action="store_true",
                   help="fetch OpenVINO IR artifacts + model-procs over "
                        "the network; validates the model list with "
                        "jsonschema, import-checks every IR before "
                        "declaring it installed")
    f.add_argument("--base-url", default=None,
                   help="--download: IR artifact root "
                        "({base}/{model}/{precision}/{model}.xml)")
    f.add_argument("--proc-base-url", default=None,
                   help="--download: model-proc root "
                        "({base}/{model}.json)")
    f.add_argument("--from-ir", default=None, metavar="DIR",
                   help="install OpenVINO IR .xml/.bin (file or tree) "
                        "into the serving layout instead of zoo export")
    f.add_argument("--alias", default=None,
                   help="serving alias for --from-ir (default: xml stem)")
    f.add_argument("--synthesize-omz", default=None, metavar="ALIAS",
                   help="materialize an OMZ-topology-shaped MobileNet-SSD "
                        "IR under ALIAS (see models/ir_build.py)")
    f.add_argument("--size", type=int, default=None,
                   help="input resolution for --synthesize-omz "
                        "(default: 512 for ssd, 72 for attributes)")
    f.add_argument("--topology",
                   choices=["ssd", "attributes", "manifest"],
                   default="ssd",
                   help="--synthesize-omz topology: MobileNet-SSD "
                        "detector, multi-head attributes classifier, "
                        "or 'manifest' = IR-backed stand-ins for every "
                        "manifest model (ALIAS ignored)")
    f.add_argument("--version", default="1")
    f.add_argument("--precision", default="FP32")
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
