"""The port's ``fetch-models`` against the reference's.

* ``models/ir_build.py`` is the reference's: every builder, given the
  same seed and arguments, writes byte-equal ``model.xml`` and
  ``model.bin``; ``--synthesize-omz`` (ssd, attributes, manifest)
  writes byte-equal trees.
* The command line keeps the reference's modes, flags and exit codes:
  each mode alone, two at once (2), a failed import (1), a model list
  that fails validation under ``--download`` (1, nothing fetched).
* ``download_models`` runs through an in-memory transport (no network
  anywhere): the same scenarios give the reference's reports and
  installed trees, and an installed IR serves in the port's registry.
* The zoo export writes the reference's layout and model-proc files,
  and the reference's registry reads the port's weights.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.cli import main as ref_cli
from evam_tpu.models import download as ref_dl
from evam_tpu.models import fetch as ref_fetch
from evam_tpu.models import ir_build as ref_build
from evam_tpu_torch.cli import main as port_cli
from evam_tpu_torch.models import download as port_dl
from evam_tpu_torch.models import fetch as port_fetch
from evam_tpu_torch.models import ir_build as port_build
from evam_tpu_torch.models.registry import ModelRegistry

torch.set_num_threads(1)


def _cli(cli, args: list[str]) -> int:
    """One command of a package's CLI, as its ``main`` runs it, without
    ``main``'s process-wide logging set-up (which would take the port's
    log records away from the later tests' ``caplog``)."""
    ns = cli.build_parser().parse_args(args)
    return ns.fn(ns)


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


BUILDERS = [
    ("crossroad", "build_crossroad_like_ir",
     {"input_size": (48, 80), "width": 8, "num_classes": 3}),
    ("crossroad_seed", "build_crossroad_like_ir",
     {"input_size": 64, "width": 4, "seed": 7}),
    ("attributes", "build_attributes_like_ir",
     {"input_size": 24, "width": 4, "heads": (("a", 3), ("b", 5), ("c", 2))}),
    ("encoder", "build_action_encoder_like_ir",
     {"input_size": 32, "width": 4, "embed_dim": 24}),
    ("decoder", "build_action_decoder_like_ir",
     {"clip_len": 6, "embed_dim": 12, "hidden": 5, "num_classes": 9}),
    ("decoder_softmax", "build_action_decoder_like_ir",
     {"clip_len": 4, "embed_dim": 8, "hidden": 3, "num_classes": 7,
      "softmax_tail": True}),
    ("aclnet", "build_aclnet_like_ir",
     {"window": 1000, "width": 4, "num_classes": 11}),
]


@pytest.mark.parametrize("name,fn,kw", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_ir_builders_write_the_references_bytes(tmp_path, name, fn, kw):
    ref = getattr(ref_build, fn)(tmp_path / "ref", **kw)
    got = getattr(port_build, fn)(tmp_path / "port", **kw)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert got[2] == ref[2]
    assert set(got[1]) == set(ref[1])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k])


@pytest.mark.parametrize("topology,alias,size", [
    ("ssd", "omz_like", 64), ("attributes", "attrs", 24),
    ("manifest", "ignored", None)])
def test_synthesize_omz_writes_the_references_tree(tmp_path, topology, alias,
                                                   size):
    args = ["fetch-models", "--synthesize-omz", alias, "--topology",
            topology, "--precision", "FP16", "--version", "3"]
    if size:
        args += ["--size", str(size)]
    assert _cli(ref_cli, args + ["--output", str(tmp_path / "ref")]) == 0
    assert _cli(port_cli, args + ["--output", str(tmp_path / "port")]) == 0
    ref, got = _tree(tmp_path / "ref"), _tree(tmp_path / "port")
    assert got == ref
    assert len(got) == (18 if topology == "manifest" else 2)


def test_synthesized_manifest_serves_every_family(tmp_path):
    """Every manifest IR loads in the port's registry as the reference
    classifies it: four SSD detectors, two classifiers, the encoder,
    the decoder (logits: the step softmaxes) and AclNet."""
    assert port_fetch.synthesize_omz(tmp_path, topology="manifest") == 0
    reg = ModelRegistry(models_dir=tmp_path, dtype="float32", device="cpu")
    want = {
        "object_detection/person_vehicle_bike": "ssd",
        "object_detection/person": "ssd",
        "object_detection/vehicle": "ssd",
        "face_detection_retail/1": "ssd",
        "object_classification/vehicle_attributes": "classifier",
        "emotion_recognition/1": "classifier",
        "action_recognition/encoder": "action_encoder",
        "action_recognition/decoder": "action_decoder",
        "audio_detection/environment": "aclnet",
    }
    for key, family in want.items():
        m = reg.get(key)
        assert (m.spec.family, m.weight_source) == (family, "ir-bin"), key
    assert reg.get("object_detection/person").spec.input_size == (320, 544)
    assert not reg.get("action_recognition/decoder").out_is_prob
    assert reg.get("audio_detection/environment").out_is_prob
    assert reg.get("object_classification/vehicle_attributes").spec.heads \
        == (("color", 7), ("type", 4))


def _src_ir(tmp: Path) -> Path:
    src = tmp / "src"
    port_build.build_attributes_like_ir(src, input_size=24, width=4)
    return src


@pytest.mark.parametrize("case", ["dir", "file", "alias_slash", "empty",
                                  "two_modes", "download_and_ir"])
def test_cli_exit_codes_match_the_reference(tmp_path, case):
    src = _src_ir(tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    args = {
        "dir": ["--from-ir", str(src), "--alias", "emotion", "--version",
                "2"],
        "file": ["--from-ir", str(src / "model.xml")],
        "alias_slash": ["--from-ir", str(src), "--alias", "a/b"],
        "empty": ["--from-ir", str(empty)],
        "two_modes": ["--from-ir", str(src), "--synthesize-omz", "x"],
        "download_and_ir": ["--download", "--from-ir", str(src)],
    }[case]
    rcs, trees = [], []
    for who, cli in (("ref", ref_cli), ("port", port_cli)):
        out = tmp_path / who
        rcs.append(_cli(cli, ["fetch-models", *args, "--output", str(out)]))
        trees.append(_tree(out) if out.exists() else {})
    assert rcs[0] == rcs[1], rcs
    assert trees[0] == trees[1]
    assert rcs[0] == {"dir": 0, "file": 0, "alias_slash": 1, "empty": 1,
                      "two_modes": 2, "download_and_ir": 2}[case]
    if case == "dir":
        m = ModelRegistry(models_dir=tmp_path / "port", dtype="float32",
                          device="cpu").get("emotion/2")
        assert m.weight_source == "ir-bin" and m.spec.family == "classifier"


def test_from_ir_refuses_a_broken_ir(tmp_path):
    """A file the importer cannot load is not installed (exit 1)."""
    src = _src_ir(tmp_path)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "model.xml").write_text(
        (src / "model.xml").read_text().replace('type="ReLU"',
                                                'type="NoSuchOp"'))
    (bad / "model.bin").write_bytes((src / "model.bin").read_bytes())
    for cli in (ref_cli, port_cli):
        out = tmp_path / cli.__name__.split(".")[0]
        assert _cli(cli, ["fetch-models", "--from-ir", str(bad), "--output",
                         str(out)]) == 1
        assert not (out / "model").exists()


def test_cli_download_fails_on_an_invalid_model_list(tmp_path, capsys):
    """``--download`` validates the list before fetching anything: an
    unknown property fails with exit 1, as the reference's does."""
    mlist = tmp_path / "list.yml"
    mlist.write_text("- model: m\n  quantize: true\n")
    for cli in (ref_cli, port_cli):
        rc = _cli(cli, ["fetch-models", "--download", "--model-list",
                       str(mlist), "--output", str(tmp_path / "out"),
                       "--base-url", "http://127.0.0.1:9/none"])
        assert rc == 1
        assert "schema validation" in capsys.readouterr().err
    assert not any((tmp_path / "out").rglob("*.xml"))


# ------------------------------------------------------ download_models


BASE = "https://mirror.test/models"
PROCS = "https://mirror.test/procs"


class DictTransport:
    """Serves url → bytes from a dict; records every fetch (the
    reference test's in-memory transport, raising each module's own
    DownloadError)."""

    def __init__(self, blobs: dict[str, bytes], error):
        self.blobs = blobs
        self.error = error
        self.fetched: list[str] = []

    def fetch(self, url: str) -> bytes:
        self.fetched.append(url)
        if url not in self.blobs:
            raise self.error(f"404: {url}")
        return self.blobs[url]


@pytest.fixture(scope="module")
def ir_bytes(tmp_path_factory):
    d = tmp_path_factory.mktemp("irsrc")
    port_build.build_crossroad_like_ir(d, input_size=64, width=8,
                                       num_classes=4)
    return (d / "model.xml").read_bytes(), (d / "model.bin").read_bytes()


def _urls(model: str, precision: str = "FP32"):
    return (f"{BASE}/{model}/{precision}/{model}.xml",
            f"{BASE}/{model}/{precision}/{model}.bin")


_PROC = json.dumps({"json_schema_version": "2.0.0", "input_preproc": [],
                    "output_postproc": []}).encode()

#: name → (model list text, url → blob builder, repeat runs with force)
_SCENARIOS = {
    "install": ("- model: crossroad\n  alias: object_detection\n"
                "  version: person_vehicle_bike\n  precision: [FP32, FP16]\n",
                lambda x, b: {**dict(zip(_urls("crossroad"), (x, b))),
                              **dict(zip(_urls("crossroad", "FP16"), (x, b))),
                              f"{PROCS}/crossroad.json": _PROC}, ()),
    "corrupt": ("- good\n- bad\n",
                lambda x, b: {**dict(zip(_urls("good"), (x, b))),
                              _urls("bad")[0]: b"<html>502</html>",
                              _urls("bad")[1]: b""}, ()),
    "skip_then_force": ("- net\n",
                        lambda x, b: dict(zip(_urls("net"), (x, b))),
                        (False, True)),
    "missing_collateral": ("- model: net\n  model-proc: nope/m.json\n",
                           lambda x, b: dict(zip(_urls("net"), (x, b))), ()),
    "html_proc": ("- net\n",
                  lambda x, b: {**dict(zip(_urls("net"), (x, b))),
                                f"{PROCS}/net.json": b"<html>502</html>"},
                  ()),
    "local_collateral": ("- model: net\n  model-proc: procs/net.json\n"
                         "  labels: labels.txt\n",
                         lambda x, b: dict(zip(_urls("net"), (x, b))), ()),
}


@pytest.mark.parametrize("scenario", list(_SCENARIOS))
def test_download_models_matches_the_reference(tmp_path, ir_bytes, scenario):
    text, blobs, repeats = _SCENARIOS[scenario]
    (tmp_path / "procs").mkdir()
    (tmp_path / "procs" / "net.json").write_bytes(_PROC)
    (tmp_path / "labels.txt").write_text("a\nb\n")
    mlist = tmp_path / "models.list.yml"
    mlist.write_text(text)
    results = []
    for dl in (ref_dl, port_dl):
        t = DictTransport(blobs(*ir_bytes), dl.DownloadError)
        out = tmp_path / dl.__name__.split(".")[0]
        reports = [dl.download_models(mlist, out, transport=t, base_url=BASE,
                                      proc_base_url=PROCS)]
        for force in repeats:
            reports.append(dl.download_models(
                mlist, out, transport=t, base_url=BASE, proc_base_url=PROCS,
                force=force))
        results.append(([(r.installed, r.skipped, r.failed) for r in reports],
                        t.fetched, _tree(out)))
    assert results[1] == results[0]


def test_downloaded_ir_serves_in_the_port(tmp_path, ir_bytes):
    t = DictTransport(dict(zip(_urls("net"), ir_bytes)), port_dl.DownloadError)
    mlist = tmp_path / "l.yml"
    mlist.write_text("- net\n")
    out = tmp_path / "models"
    assert port_dl.download_models(mlist, out, transport=t, base_url=BASE,
                                   proc_base_url=PROCS).ok
    m = ModelRegistry(models_dir=out, dtype="float32", device="cpu").get(
        "net/1")
    assert m.weight_source == "ir-bin"
    with torch.inference_mode():
        outp = m.forward(torch.zeros(1, 64, 64, 3))
    assert outp["loc"].shape[:2] == (1, len(m.anchors))


@pytest.mark.parametrize("data", [
    ["mobilenet-ssd", {"model": "p", "alias": "a", "version": 1,
                       "precision": ["FP16", "BF16"], "model-proc": "x.json",
                       "labels": "l.txt"}],
    [{"alias": "x"}], [{"model": "m", "quantize": True}],
    [{"model": "m", "precision": ["FP64"]}], {"model": "m"}])
def test_validate_model_list_matches_the_reference(data):
    outcomes = []
    for dl in (ref_dl, port_dl):
        try:
            outcomes.append(("ok", dl.validate_model_list(data)))
        except dl.DownloadError as exc:
            outcomes.append(("error", str(exc)))
    assert outcomes[1] == outcomes[0]


def test_model_entry_resolution_matches_the_reference(tmp_path):
    for raw in ("some-model", {"model": "m", "model-proc": "procs/m.json",
                               "labels": "l.txt", "version": 4,
                               "precision": ["FP16"]}):
        ref = ref_dl.ModelEntry.resolve(raw, tmp_path / "sub" / "l.yml")
        got = port_dl.ModelEntry.resolve(raw, tmp_path / "sub" / "l.yml")
        assert vars(got) == vars(ref)


def test_parse_model_list_matches_the_reference(tmp_path):
    mlist = tmp_path / "l.yml"
    mlist.write_text("# manifest\n- plain-model\n- model: m\n"
                     "  alias: a  # comment\n  precision: [FP16, BF16]\n")
    assert port_fetch.parse_model_list(mlist) == \
        ref_fetch.parse_model_list(mlist)
    assert port_fetch.parse_model_list("models_list/models.list.yml") == \
        ref_fetch.parse_model_list("models_list/models.list.yml")
    mlist.write_text("- model: m\n  precision: [FP64]\n")
    for fetch in (ref_fetch, port_fetch):
        with pytest.raises(fetch.ModelListError, match="FP64"):
            fetch.parse_model_list(mlist)


def test_zoo_export_writes_the_reference_layout(tmp_path):
    """The default mode exports the zoo's (seeded) weights and the
    reference's model-proc files; the reference's registry reads the
    port's weights file."""
    from evam_tpu.models.registry import ModelRegistry as JaxRegistry

    mlist = tmp_path / "l.yml"
    mlist.write_text("- model: emotions-recognition-retail-0003\n"
                     "  alias: emotion_recognition\n  version: 1\n"
                     "  precision: [FP32]\n")
    for cli, who in ((port_cli, "port"), (ref_cli, "ref")):
        assert _cli(cli, ["fetch-models", "--model-list", str(mlist),
                         "--output", str(tmp_path / who)]) == 0
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert set(port) == set(ref)
    proc = "emotion_recognition/1/emotions-recognition-retail-0003.json"
    assert port[proc] == ref[proc]
    key = "emotion_recognition/1"
    jm = JaxRegistry(models_dir=tmp_path / "port", dtype="float32",
                     precision="FP32", allow_random_weights=False).get(key)
    assert jm.weight_source == "msgpack"
    tm = ModelRegistry(models_dir=tmp_path / "port", dtype="float32",
                       precision="FP32", device="cpu",
                       allow_random_weights=False).get(key)
    assert tm.weight_source == "msgpack"
