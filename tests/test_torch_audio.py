"""Audio detection in the port against the reference, on the CPU.

Tolerance: atol 1e-5 on float32 logits and probabilities (convolution
sums in another order); the audio stages and sources are copies, held
exactly.

* ``AclNet`` (width 8) at 1600 and 16000 samples, with the reference's
  weights through ``params_from_jax``: flax's ``"SAME"`` padding is
  asymmetric (2 left and 3 right at 16000 and stride 4), and the two
  lengths split differently at the fourth conv.
* ``build_audio_step`` on int16 windows, weights read from the
  reference's ``weights.msgpack``, at float32 and INT8 (bfloat16
  weights, float32 arithmetic in both).
* ``AudioMixStage``'s chunks, pts and seq on uneven input, and
  ``LevelStage``'s messages, equal to the reference's.
* ``WavSource`` on ``.wav`` files written with ``wave`` (16-bit mono at
  16 kHz, 8-bit stereo at 8 kHz), ``SyntheticAudioSource`` and
  ``create_source``'s resolution of both, equal to the reference's.
* ``audio_detection/environment`` through both stage chains at
  ``sliding-window`` 1.0 and 0.2 (the same windows, labels and
  confidences within 1e-5), and through both REST servers at float32
  and INT8.
"""

from __future__ import annotations

import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.engine import steps as jsteps
from evam_tpu.graph import PipelineLoader as JaxLoader
from evam_tpu.graph import resolve_parameters as jresolve
from evam_tpu.media import audio as jaudio
from evam_tpu.media.source import create_source as jcreate_source
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.stages import StreamRunner as JaxRunner
from evam_tpu.stages import build_stages as jbuild
from evam_tpu.stages import misc as jmisc
from evam_tpu.stages.context import FrameContext as JContext
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media import audio as taudio
from evam_tpu_torch.media.source import create_source
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops.padding import same_pads
from evam_tpu_torch.stages import misc as tmisc
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.runner import StreamRunner
from test_torch_action import serve_pair
from test_torch_server import REPO

torch.set_num_threads(1)
ATOL = 1e-5
KEY = "audio_detection/environment"
PATH = "/pipelines/" + KEY


def _registries(samples: int = 1600, dtype: str = "float32",
                models_dir=None):
    kw = dict(models_dir=models_dir, dtype=dtype,
              input_overrides={KEY: (1, samples)}, width_overrides={KEY: 8},
              allow_random_weights=True)
    return JaxRegistry(**kw), ModelRegistry(device="cpu", **kw)


def _windows(n: int, samples: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -32768, 32768, (n, samples)).astype(np.int16)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("samples", [1600, 16000])
def test_aclnet_matches_the_reference(samples):
    jreg, treg = _registries(samples)
    jm, tm = jreg.get(KEY), treg.get(KEY)
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jm.params)))
    x = _windows(3, samples).astype(np.float32) / 32768.0
    ref = np.asarray(jm.forward(jm.params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tm.forward(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 53)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("samples,splits", [
    # (left, right) pad of each conv's samples axis, as XLA pads SAME
    (16000, [(2, 3), (2, 3), (2, 3), (3, 4), (4, 4)]),
    (1600, [(2, 3), (2, 3), (2, 3), (4, 4), (4, 4)]),
])
def test_same_padding_splits_as_flax(samples, splits):
    """The five convs' splits along the samples: the two lengths part
    at the fourth conv (250 samples pad 3 and 4, 25 pad 4 and 4)."""
    got = []
    n = samples
    for stride in (4, 4, 4, 4, 2):
        lo, hi, n = same_pads(n, 9, stride)
        got.append((lo, hi))
    assert got == splits


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_audio_step_matches_the_reference(tmp_path, dtype):
    jreg, _ = _registries(16000, dtype, tmp_path)
    jreg.get(KEY)
    jreg.save_weights(KEY)
    jreg, treg = _registries(16000, dtype, tmp_path)
    jm, tm = jreg.get(KEY), treg.get(KEY)
    assert tm.weight_source == "msgpack"
    windows = _windows(4, 16000, seed=1)
    ref = np.asarray(jsteps.build_audio_step(jm)(jm.params,
                                                 jnp.asarray(windows)))
    got = tsteps.build_audio_step(tm)(torch.from_numpy(windows)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 53)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


# --------------------------------------------------------------- stages


def _chunks(seed: int = 0) -> list[np.ndarray]:
    """Uneven chunks: lengths that do not divide the mixer's chunk."""
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, n).astype(np.int16)
            for n in (700, 1, 1599, 3200, 2500, 0, 999, 4000)]


@pytest.mark.parametrize("duration_ns", [None, 50_000_000, 250_000_000])
def test_audio_mix_chunks_as_the_reference(duration_ns):
    props = {} if duration_ns is None else {
        "output-buffer-duration": duration_ns}
    ref = jmisc.AudioMixStage("mix", dict(props))
    got = tmisc.AudioMixStage("mix", dict(props))
    n_out = 0
    for i, chunk in enumerate(_chunks()):
        r = ref.process(JContext(frame=None, pts_ns=i, seq=i, stream_id="s",
                                 source_uri="u", audio=chunk))
        g = got.process(FrameContext(frame=None, pts_ns=i, seq=i,
                                     stream_id="s", source_uri="u",
                                     audio=chunk))
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert (a.pts_ns, a.seq, a.stream_id, a.source_uri) == (
                b.pts_ns, b.seq, b.stream_id, b.source_uri)
            np.testing.assert_array_equal(a.audio, b.audio)
            assert a.audio.dtype == np.int16
        n_out += len(g)
    assert n_out == sum(map(len, _chunks())) // got.chunk > 0
    # a video context passes through
    ctx = FrameContext(frame=np.zeros((2, 2, 3), np.uint8), pts_ns=0, seq=0,
                       stream_id="s")
    assert got.process(ctx) == [ctx]


@pytest.mark.parametrize("post", [True, False])
def test_level_messages_as_the_reference(post):
    ref = jmisc.LevelStage("level", {"post-messages": post})
    got = tmisc.LevelStage("level", {"post-messages": post})
    for i, chunk in enumerate(_chunks(1) + [np.zeros(160, np.int16)]):
        r = JContext(frame=None, pts_ns=i, seq=i, stream_id="s", audio=chunk
                     if len(chunk) else np.zeros(1, np.int16))
        g = FrameContext(frame=None, pts_ns=i, seq=i, stream_id="s",
                         audio=r.audio)
        ref.process(r)
        assert got.process(g) == [g]
        assert g.messages == r.messages
        assert len(g.messages) == int(post)


# -------------------------------------------------------------- sources


def _write_wav(path, rate: int, channels: int, width: int, seconds: float):
    n = int(rate * seconds)
    t = np.arange(n) / rate
    mono = np.sin(2 * np.pi * 330 * t)
    if width == 2:
        data = (mono * 9000).astype(np.int16)
    else:
        data = (mono * 100 + 128).astype(np.uint8)
    data = np.repeat(data[:, None], channels, axis=1)
    data[:, -1] = data[:, -1] // 2 if width == 2 else data[:, -1]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def _events(source) -> list:
    return [(e.seq, e.pts_ns, e.frame, e.audio) for e in source.frames()]


def _assert_events_equal(got, ref) -> None:
    assert len(got) == len(ref) > 0
    for (gs, gp, gf, ga), (rs, rp, rf, ra) in zip(got, ref):
        assert (gs, gp, gf, rf) == (rs, rp, None, None)
        assert ga.dtype == ra.dtype == np.int16
        np.testing.assert_array_equal(ga, ra)


@pytest.mark.parametrize("rate,channels,width", [(16000, 1, 2),
                                                 (8000, 2, 1),
                                                 (44100, 2, 2)])
def test_wav_source_matches_the_reference(tmp_path, rate, channels, width):
    path = tmp_path / "a.wav"
    _write_wav(path, rate, channels, width, 1.23)
    got = _events(create_source({"uri": str(path), "type": "uri"}))
    ref = _events(jcreate_source({"uri": str(path), "type": "uri"}))
    _assert_events_equal(got, ref)
    _assert_events_equal(_events(taudio.WavSource(f"file://{path}",
                                                  chunk_ms=30)),
                         _events(jaudio.WavSource(f"file://{path}",
                                                  chunk_ms=30)))


def test_synthetic_audio_source_matches_the_reference():
    for uri in ("synthetic-audio://seconds=1.5&seed=3",
                "synthetic-audio://seconds=0.35"):
        got = create_source({"uri": uri, "type": "uri"})
        assert isinstance(got, taudio.SyntheticAudioSource)
        _assert_events_equal(_events(got), _events(jcreate_source(
            {"uri": uri, "type": "uri"})))


# ------------------------------------------------------------- pipeline


def _chain_outputs(loader, resolve, build, runner_cls, source, hub,
                   params) -> list:
    spec = loader(REPO / "pipelines").get("audio_detection", "environment")
    stages, _ = resolve(spec, params)
    outputs = []
    runner = runner_cls("s", build(stages, hub, source_uri="synthetic://t",
                                   publish_fn=lambda c: outputs.append(
                                       c.metadata)),
                        source_uri="synthetic://t")
    runner.run(source.frames())
    assert runner.errors == 0
    return outputs


def assert_detections_agree(ref: list, got: list, atol: float) -> int:
    """The same lines (timestamps, level messages), a detection tensor
    on the same lines with the same label and confidence within
    ``atol``. Returns the number of detections."""
    assert len(got) == len(ref)
    n = 0
    for g, r in zip(got, ref):
        assert (g["timestamp"], g.get("level")) == (r["timestamp"],
                                                    r.get("level"))
        assert ("tensors" in g) == ("tensors" in r)
        if "tensors" not in r:
            continue
        (gt,), (rt,) = g["tensors"], r["tensors"]
        assert (gt["name"], gt["label"], gt["label_id"]) == (
            rt["name"], rt["label"], rt["label_id"]) == (
            "detection", rt["label"], rt["label_id"])
        assert abs(gt["confidence"] - rt["confidence"]) <= atol
        n += 1
    return n


@pytest.mark.parametrize("window", [1.0, 0.2])
def test_pipeline_matches_the_reference(tmp_path, window):
    jreg, _ = _registries(16000, models_dir=tmp_path)
    jreg.get(KEY)
    jreg.save_weights(KEY)
    jreg, treg = _registries(16000, models_dir=tmp_path)
    params = {"threshold": 0.0, "sliding-window": window,
              "post-messages": True}
    jhub = JaxHub(jreg, max_batch=16, deadline_ms=4.0)
    thub = EngineHub(treg, device="cpu", max_batch=16, deadline_ms=4.0)
    try:
        ref = _chain_outputs(JaxLoader, jresolve, jbuild, JaxRunner,
                             jaudio.SyntheticAudioSource(seconds=3.0, seed=2),
                             jhub, params)
        got = _chain_outputs(PipelineLoader, resolve_parameters, build_stages,
                             StreamRunner,
                             taudio.SyntheticAudioSource(seconds=3.0, seed=2),
                             thub, params)
    finally:
        jhub.stop()
        thub.stop()
    assert len(got) == 30  # 3 s in 100 ms chunks
    # the host replay of the stride rule: the first window after 1 s,
    # then one every sliding-window seconds
    stride = int(16000 * window) // 1600
    want = [i for i in range(30) if i >= 9 and (i - 9) % stride == 0]
    assert [i for i, m in enumerate(got) if "tensors" in m] == want
    assert assert_detections_agree(ref, got, ATOL) == len(want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_rest_metadata_matches_the_reference(tmp_path, dtype):
    models = tmp_path / "models"
    jreg, _ = _registries(16000, dtype, models)
    ref, got, _, engines = serve_pair(
        tmp_path, jreg, lambda: _registries(16000, dtype, models)[1], (KEY,),
        PATH, {"parameters": {"threshold": 0.0, "sliding-window": 0.5}},
        "synthetic-audio://seconds=2&seed=1")
    assert len(got) == 20
    assert list(engines) == [f"audio:{KEY}"]
    assert engines[f"audio:{KEY}"]["items"] == 3
    assert assert_detections_agree(ref, got, ATOL) == 3
