"""The accuracy harness's temporal half (``render_temporal_clip``,
``fit_action``, ``render_tone_window``, ``fit_audio`` in
``evam_tpu_torch/models/accuracy.py``) against the reference's, on the
CPU.

The fits are asserted to convergence only on the card (``chip_smoke.py``'s
``temporal`` phase: the reference's ``TestTemporalAccuracy`` limits).
Here the port is held to the reference step by step, at the reference
test's cut sizes (encoder 48×48, width 8, embed 512; decoder dim 128,
depth 4, 8 heads; AclNet width 8 over 16000 samples), with fewer clips
and windows:

* ``TEMPORAL_CLASSES``, ``TONE_FREQS``, ``render_temporal_clip`` and
  ``render_tone_window``: equal (numpy copies; the int16 samples bit for
  bit), and the generator left in the same state;
* the fits' training arrays and minibatch order: equal to the batches
  the reference's ``fit_action`` and ``fit_audio`` hand their jitted
  step, read by replacing ``jax.jit`` with a recorder for that call (the
  reference shrinks its odd clips with ``cv2.resize(INTER_AREA)``, the
  port with ``resize_area_host``: the action test is skipped without
  cv2);
* the loss after one and two steps from the reference's initial weights
  within 1e-5 relative, and the parameters by
  ``test_torch_accuracy.py``'s rule (atol 1e-6 where the reference's
  first step moved an entry by ≥ 0.99·lr, Adam's travel bound
  elsewhere);
* a few port fit steps written by ``save_fitted`` and served from the
  models dir by both packages' stage chains: one 16-frame clip through
  ``action_recognition/general`` and a 2 s tone through
  ``audio_detection/environment`` (sliding-window 0.5); the published
  probabilities and confidences within 1e-5 (float32; measured ~1e-7),
  argmax and label ids equal.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.engine import steps as jsteps
from evam_tpu.graph import PipelineLoader as JaxLoader
from evam_tpu.graph import resolve_parameters as jresolve
from evam_tpu.media.source import FrameEvent as JaxFrameEvent
from evam_tpu.models import accuracy as ref
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.stages import StreamRunner as JaxRunner
from evam_tpu.stages import build_stages as jbuild
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import FrameEvent
from evam_tpu_torch.models import accuracy as acc
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.stages.runner import StreamRunner
from test_torch_accuracy import _assert_first_updates, _recording_jit, _state
from test_torch_action import assert_actions_agree
from test_torch_audio import assert_detections_agree
from test_torch_server import REPO, native_reference  # noqa: F401 — fixture

torch.set_num_threads(1)
ENC = "action_recognition/encoder"
DEC = "action_recognition/decoder"
AUD = "audio_detection/environment"
#: the reference test's temporal configuration (tests/test_accuracy.py:387)
TEMPORAL = dict(input_overrides={ENC: (48, 48)},
                width_overrides={ENC: 8, DEC: 8, AUD: 8})
ACTION_LR, AUDIO_LR = 5e-4, 3e-3
#: the fits' data at the small size
ACTION_FIT = dict(n_clips=8, batch=4)
AUDIO_FIT = dict(n_windows=32, batch=8)
ATOL = 1e-5


def _jax_registry(**kw):
    return JaxRegistry(dtype="float32", allow_random_weights=True,
                       **TEMPORAL, **kw)


def _port_registry(dtype="float32", **kw):
    return ModelRegistry(dtype=dtype, device="cpu", allow_random_weights=True,
                         **TEMPORAL, **kw)


@pytest.fixture(scope="module")
def models():
    """The reference's models at the temporal configuration, and the
    port's with the reference's initial weights: {key: (jax, port)}."""
    jreg, treg = _jax_registry(), _port_registry()
    out = {}
    for key in (ENC, DEC, AUD):
        jm, tm = jreg.get(key), treg.get(key)
        tm.module.load_state_dict(_state(jm.params))
        out[key] = (jm, tm)
    return out


def _pair(models):
    """The action fit's encoder and decoder as one reference tree and one
    port module (the shapes ``_assert_first_updates`` reads)."""
    (je, te), (jd, td) = models[ENC], models[DEC]
    return (SimpleNamespace(params={"enc": je.params, "dec": jd.params}),
            SimpleNamespace(module=torch.nn.ModuleDict(
                {"enc": te.module, "dec": td.module})))


# ------------------------------------------------------ numpy copies


def test_temporal_constants_equal_reference():
    assert acc.TEMPORAL_CLASSES == ref.TEMPORAL_CLASSES
    assert acc.TONE_FREQS == ref.TONE_FREQS


@pytest.mark.parametrize("hw", [(48, 48), (64, 96), (224, 224)], ids=str)
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_render_temporal_clip_equals_reference(seed, hw):
    rng_ref, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for cls in range(len(acc.TEMPORAL_CLASSES)):
        want = ref.render_temporal_clip(rng_ref, cls, hw)
        got = acc.render_temporal_clip(rng, cls, hw)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (16,) + hw + (3,)
        np.testing.assert_array_equal(got, want)
    assert rng.integers(0, 2**62) == rng_ref.integers(0, 2**62)


@pytest.mark.parametrize("n_samples", [1600, 16000])
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_render_tone_window_equals_reference(seed, n_samples):
    rng_ref, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for cls in range(len(acc.TONE_FREQS)):
        want = ref.render_tone_window(rng_ref, cls, n_samples)
        got = acc.render_tone_window(rng, cls, n_samples)
        assert got.dtype == want.dtype == np.int16
        assert got.shape == want.shape == (n_samples,)
        np.testing.assert_array_equal(got, want)
    assert rng.integers(0, 2**62) == rng_ref.integers(0, 2**62)


# --------------------------------------------------------------- fit


@pytest.mark.parametrize("n_clips,batch,steps", [(6, 4, 5), (9, 2, 3)])
def test_action_data_and_order_equal_the_references(models, monkeypatch,
                                                    n_clips, batch, steps):
    """The batches the reference's ``fit_action`` hands its jitted step,
    in order, against the port's arrays indexed by the port's order."""
    pytest.importorskip("cv2")  # the reference shrinks with cv2
    (je, te), (jd, _) = models[ENC], models[DEC]
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref.fit_action(je, jd, seed=5, n_clips=n_clips, steps=steps, batch=batch)
    monkeypatch.undo()
    rng = np.random.default_rng(5)
    clips, ys = acc._temporal_data(te, rng, n_clips, (64, 96))
    order = acc._replacement_batches(rng, n_clips, steps, batch)
    assert clips.dtype == np.uint8 and clips.shape == (n_clips, 16, 48, 48, 3)
    assert ys.dtype == np.int32 and set(ys) <= set(range(4))
    assert len(seen) == steps == len(order)
    for (w_clips, w_ys), idx in zip(seen, order):
        assert (w_clips.dtype, w_ys.dtype) == (clips.dtype, ys.dtype)
        np.testing.assert_array_equal(clips[idx], w_clips)
        np.testing.assert_array_equal(ys[idx], w_ys)


@pytest.mark.parametrize("n_windows,batch,steps", [(12, 4, 5), (9, 5, 3)])
def test_audio_data_and_order_equal_the_references(models, monkeypatch,
                                                   n_windows, batch, steps):
    jm, tm = models[AUD]
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref.fit_audio(jm, seed=6, n_windows=n_windows, steps=steps, batch=batch)
    monkeypatch.undo()
    rng = np.random.default_rng(6)
    xs, ys = acc._audio_data(tm, rng, n_windows)
    order = acc._replacement_batches(rng, n_windows, steps, batch)
    assert xs.dtype == np.int16 and xs.shape == (n_windows, 16000)
    assert ys.dtype == np.int64 and set(ys) <= set(range(4))
    assert len(seen) == steps == len(order)
    for (w_xs, w_ys), idx in zip(seen, order):
        np.testing.assert_array_equal(xs[idx], w_xs)
        np.testing.assert_array_equal(ys[idx], w_ys)


@pytest.fixture(scope="module")
def action_first_steps(models):
    """One- and two-step action fits of both packages from the same
    initial weights: {steps: (reference state, port state, reference
    history, port history)}, each state over both modules."""
    pytest.importorskip("cv2")  # the reference shrinks with cv2
    (je, te), (jd, td) = models[ENC], models[DEC]
    out = {}
    for steps in (1, 2):
        (rp_e, rp_d), rh = ref.fit_action(je, jd, steps=steps, **ACTION_FIT)
        (tp_e, tp_d), th = acc.fit_action(te, td, steps=steps, device="cpu",
                                          **ACTION_FIT)
        port = {f"enc.{k}": v for k, v in tp_e.items()}
        port.update({f"dec.{k}": v for k, v in tp_d.items()})
        out[steps] = (_state({"enc": rp_e, "dec": rp_d}), port, rh, th)
    return out


@pytest.mark.parametrize("steps", [1, 2])
def test_fit_action_loss_and_first_updates_match_reference(
        models, action_first_steps, steps):
    _assert_first_updates(*_pair(models), action_first_steps, steps,
                          ACTION_LR)


@pytest.fixture(scope="module")
def audio_first_steps(models):
    jm, tm = models[AUD]
    out = {}
    for steps in (1, 2):
        rp, rh = ref.fit_audio(jm, steps=steps, **AUDIO_FIT)
        tp, th = acc.fit_audio(tm, steps=steps, device="cpu", **AUDIO_FIT)
        out[steps] = (_state(rp), tp, rh, th)
    return out


@pytest.mark.parametrize("steps", [1, 2])
def test_fit_audio_loss_and_first_updates_match_reference(
        models, audio_first_steps, steps):
    _assert_first_updates(*models[AUD], audio_first_steps, steps, AUDIO_LR)


def test_fits_run_on_the_card_unless_asked(models):
    (_, te), (_, td), (_, ta) = models[ENC], models[DEC], models[AUD]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.fit_action(te, td, steps=1, n_clips=2, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.fit_audio(ta, steps=1, n_windows=2, batch=2)


@pytest.mark.parametrize("source_hw", [(32, 96), (64, 40), (47, 48)],
                         ids=str)
def test_fit_action_refuses_to_enlarge(models, source_hw):
    """The area resize only shrinks: a ``source_hw`` under the encoder's
    48×48 on either axis raises before any data is made."""
    (_, te), (_, td) = models[ENC], models[DEC]
    with pytest.raises(ValueError, match="only shrinks"):
        acc.fit_action(te, td, steps=1, n_clips=2, batch=2,
                       source_hw=source_hw, device="cpu")


def _bf16(model):
    """``model`` with a bfloat16 copy of its module."""
    return dataclasses.replace(
        model, module=copy.deepcopy(model.module).to(torch.bfloat16))


def _assert_float32_copy(state, m32, m, was) -> None:
    """A fitted float32 ``state`` under ``m32``'s keys; ``m``'s bfloat16
    module left as it ``was``."""
    assert {v.dtype for v in state.values()} == {torch.float32}
    assert state.keys() == m32.module.state_dict().keys()
    for k, v in m.module.state_dict().items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, was[k], rtol=0, atol=0)


def test_fit_action_fits_copies_in_float32(models):
    """bfloat16 encoder and decoder modules come back as float32 states
    under their own keys, the modules themselves untouched."""
    (_, te32), (_, td32) = models[ENC], models[DEC]
    te, td = _bf16(te32), _bf16(td32)
    before = [copy.deepcopy(m.module.state_dict()) for m in (te, td)]
    timings = {}
    (enc_state, dec_state), history = acc.fit_action(
        te, td, steps=2, n_clips=2, batch=2, source_hw=None, device="cpu",
        timings=timings)
    assert len(history) == 2 and all(np.isfinite(history))
    assert timings.keys() == {"data_s", "steps_s"}
    _assert_float32_copy(enc_state, te32, te, before[0])
    _assert_float32_copy(dec_state, td32, td, before[1])


def test_fit_audio_fits_a_copy_in_float32(models):
    _, ta32 = models[AUD]
    ta = _bf16(ta32)
    before = copy.deepcopy(ta.module.state_dict())
    timings = {}
    state, history = acc.fit_audio(ta, steps=2, n_windows=4, batch=2,
                                   device="cpu", timings=timings)
    assert len(history) == 2 and all(np.isfinite(history))
    assert timings.keys() == {"data_s", "steps_s"}
    _assert_float32_copy(state, ta32, ta, before)


# ------------------------------------------------ served in both packages


@pytest.fixture(scope="module")
def fitted_dir(tmp_path_factory):
    """A few port fit steps of both temporal fits, written by
    ``save_fitted``."""
    treg = _port_registry()
    (enc_state, dec_state), ah = acc.fit_action(
        treg.get(ENC), treg.get(DEC), steps=4, n_clips=8, batch=2,
        device="cpu")
    aud_state, dh = acc.fit_audio(treg.get(AUD), steps=4, n_windows=16,
                                  batch=4, device="cpu")
    assert all(np.isfinite(ah + dh))
    root = tmp_path_factory.mktemp("temporal_fitted")
    for state, key in ((enc_state, ENC), (dec_state, DEC), (aud_state, AUD)):
        path = acc.save_fitted(state, key, root)
        assert path == root / key / "FP32" / "weights.msgpack"
    return root


def _chain(loader, resolve, build, runner_cls, hub, pipeline, params,
           events) -> list[dict]:
    spec = loader(REPO / "pipelines").get(*pipeline)
    stages, _ = resolve(spec, params)
    outputs = []
    runner = runner_cls("acc", build(stages, hub, source_uri="synthetic://acc",
                                     publish_fn=lambda c: outputs.append(
                                         c.metadata)),
                        source_uri="synthetic://acc")
    runner.run(events)
    assert runner.errors == 0
    return outputs


def _serve_both(root, pipeline, params, events):
    """``events(FrameEvent)`` through the pipeline in both packages, on
    registries that load ``root``'s fitted weights → (reference lines,
    port lines, reference registry, port registry)."""
    jreg = JaxRegistry(dtype="float32", models_dir=str(root), **TEMPORAL)
    treg = ModelRegistry(dtype="float32", models_dir=root, device="cpu",
                         **TEMPORAL)
    jhub = JaxHub(jreg, max_batch=16, deadline_ms=4.0)
    thub = EngineHub(treg, device="cpu", max_batch=16, deadline_ms=4.0)
    try:
        want = _chain(JaxLoader, jresolve, jbuild, JaxRunner, jhub, pipeline,
                      params, events(JaxFrameEvent))
        got = _chain(PipelineLoader, resolve_parameters, build_stages,
                     StreamRunner, thub, pipeline, params, events(FrameEvent))
    finally:
        jhub.stop()
        thub.stop()
    return want, got, jreg, treg


@pytest.mark.usefixtures("native_reference")
def test_fitted_action_serves_alike_in_both_packages(fitted_dir):
    clip = acc.render_temporal_clip(np.random.default_rng(42), 2, (64, 96))

    def events(cls):
        return (cls(frame=f, pts_ns=i * 33, seq=i) for i, f in enumerate(clip))

    want, got, jreg, treg = _serve_both(
        fitted_dir, ("action_recognition", "general"), {}, events)
    for key in (ENC, DEC):
        assert jreg.get(key).weight_source == "msgpack"
        assert treg.get(key).weight_source == "msgpack"
    assert len(got) == 16
    # exactly the 16th frame carries the clip's probabilities
    assert [i for i, m in enumerate(got) if m.get("tensors")] == [15]
    assert_actions_agree(want, got, ATOL)


@pytest.mark.usefixtures("native_reference")
def test_fitted_audio_serves_alike_in_both_packages(fitted_dir):
    t = np.arange(32000, dtype=np.float64) / 16000.0
    wave = np.clip(0.5 * np.sin(2 * np.pi * acc.TONE_FREQS[1] * t) * 32767,
                   -32768, 32767).astype(np.int16)

    def events(cls):
        return (cls(frame=None, audio=wave[i:i + 1600], pts_ns=i,
                    seq=i // 1600) for i in range(0, len(wave), 1600))

    want, got, jreg, treg = _serve_both(
        fitted_dir, ("audio_detection", "environment"),
        {"threshold": 0.0, "sliding-window": 0.5}, events)
    assert len(got) == 20
    assert assert_detections_agree(want, got, ATOL) == 3
    # the whole probability vector of each window, through both steps
    jm, tm = jreg.get(AUD), treg.get(AUD)
    assert jm.weight_source == tm.weight_source == "msgpack"
    windows = np.stack([wave[i:i + 16000] for i in (0, 8000, 16000)])
    want_p = np.asarray(jax.jit(jsteps.build_audio_step(jm))(jm.params,
                                                            windows))
    got_p = tsteps.build_audio_step(tm)(torch.from_numpy(windows)).numpy()
    assert got_p.shape == want_p.shape == (3, 53)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got_p.argmax(-1), want_p.argmax(-1))
