"""``fit_detector`` through an imported OpenVINO IR
(``evam_tpu_torch/models/accuracy.py``, ``models/ir.py``) against the
reference's fit of the same IR (``evam_tpu/models/accuracy.py``), on the
CPU.

The fit runs to convergence only on the card (``chip_smoke.py``'s
``irfit`` phase: the reference test's loss, recall and precision
limits). Here the crossroad-like IR (``models/ir_build.py``) at 64²,
width 8, 4 classes — a MobileNet ladder of ``Convolution`` and depthwise
``GroupConvolution`` + bias + ReLU, heads through ``Transpose`` and
``Reshape``, the in-graph ``SoftMax``, folded ``PriorBox`` anchors — is
loaded by both registries, and the port is held to the reference, with
the port's IR built in each plan: ``EVAM_IR_LAYOUT`` nhwc (its
convolution weights stored ``channels_last``), nchw, and nchw under
``EVAM_DWCONV=shift`` (shift-and-add depthwise):

* the training arrays and minibatch order: equal to the batches the
  reference's fit hands its jitted step (``test_torch_accuracy.py``'s
  ``jax.jit`` recorder);
* the loss at the initial weights within 1e-5 relative, and the weights
  after one and two Adam steps within ``test_torch_accuracy.py``'s
  first-update tolerances (1e-6 wherever the reference's first step
  moved an entry by 0.99·lr; else twice Adam's bound on each side's
  travel). The folded priors take no gradient and stay exactly; the
  fitted flat dict comes back in the reference's order (sorted by name,
  as ``jax.tree.map`` leaves it), float32;
* the model the caller passed is left as it was (its weights, their
  memory format, and that they take no gradient);
* a 40-step port fit written by ``save_fitted`` beside the IR: the bytes
  the reference's ``save_fitted`` writes for the same dict; each
  registry loads the other's file as ``ir-bin+override`` with the same
  weights; both packages' ``build_detect_step`` on 1080p i420 held-out
  scenes at float32: valid masks and labels equal, every field within
  1e-5.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax

from evam_tpu.engine.steps import build_detect_step as jax_detect_step
from evam_tpu.models import accuracy as ref
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu_torch.engine.steps import build_detect_step
from evam_tpu_torch.models import accuracy as acc
from evam_tpu_torch.models.convert import flat_to_msgpack, flat_from_msgpack
from evam_tpu_torch.models.ir_build import build_crossroad_like_ir
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops.color import bgr_to_i420_host
from test_torch_accuracy import LR, _adam_travel, _recording_jit

torch.set_num_threads(1)
KEY = "object_detection/person_vehicle_bike"
FIT = dict(n_scenes=8, batch=4)
#: the port's plans: (EVAM_IR_LAYOUT, EVAM_DWCONV)
PLANS = {"nhwc": ("nhwc", "lax"), "nchw": ("nchw", "lax"),
         "nchw-shift": ("nchw", "shift")}


def _write_ir(root):
    ir_dir = root / KEY / "FP32"
    ir_dir.mkdir(parents=True)
    build_crossroad_like_ir(ir_dir, input_size=64, width=8, num_classes=4)
    return root


@pytest.fixture(scope="module")
def ir_root(tmp_path_factory):
    return _write_ir(tmp_path_factory.mktemp("ir"))


def _port_model(root, plan: str = "nhwc"):
    layout, dwconv = PLANS[plan]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EVAM_IR_LAYOUT", layout)
        mp.setenv("EVAM_DWCONV", dwconv)
        return ModelRegistry(dtype="float32", device="cpu",
                             models_dir=root).get(KEY)


@pytest.fixture(scope="module")
def jax_model(ir_root):
    jm = JaxRegistry(dtype="float32", models_dir=str(ir_root)).get(KEY)
    assert jm.ir is not None and jm.module is None
    assert jm.weight_source == "ir-bin"
    return jm


def test_the_ir_loads_as_an_imported_detector(ir_root, jax_model):
    tm = _port_model(ir_root)
    assert tm.weight_source == "ir-bin" and tm.ir is not None
    assert tm.spec.input_size == jax_model.spec.input_size == (64, 64)
    assert tm.conf_is_prob and jax_model.conf_is_prob
    np.testing.assert_array_equal(tm.anchors, np.asarray(jax_model.anchors))
    assert tm.variances == jax_model.variances
    assert list(tm.ir.params) == list(jax_model.params)


@pytest.mark.parametrize("n_scenes,batch,steps", [(8, 4, 5), (6, 8, 3)])
def test_ir_fit_data_and_order_equal_the_references(ir_root, jax_model,
                                                    monkeypatch, n_scenes,
                                                    batch, steps):
    pytest.importorskip("cv2")  # the reference shrinks with cv2
    seen = []
    monkeypatch.setattr(jax, "jit", _recording_jit(seen))
    ref.fit_detector(jax_model, seed=7, n_scenes=n_scenes, steps=steps,
                     batch=batch)
    monkeypatch.undo()
    tm = _port_model(ir_root)
    rng = np.random.default_rng(7)
    arrays = acc._fit_data(tm, rng, n_scenes)
    order = acc._minibatches(rng, n_scenes, steps, batch)
    assert arrays[0].shape == (n_scenes, 64, 64, 3)
    assert len(seen) == steps == len(order)
    for want, idx in zip(seen, order):
        for w, a in zip(want, arrays):
            assert w.dtype == a.dtype
            np.testing.assert_array_equal(a[idx], w)


def _flat(tree) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def ref_steps(jax_model):
    """The reference's one- and two-step fits: {steps: (weights,
    history)}, keys in the order its fit returns them."""
    out = {}
    for steps in (1, 2):
        params, history = ref.fit_detector(jax_model, steps=steps, **FIT)
        out[steps] = (_flat(params), history)
    return out


@pytest.mark.parametrize("plan", list(PLANS))
def test_ir_fit_loss_and_first_updates_match_reference(ir_root, jax_model,
                                                       ref_steps, plan):
    tm = _port_model(ir_root, plan)
    init = _flat(jax_model.params)
    before = {k: v.clone() for k, v in tm.ir.params.items()}
    formats = {k: v.is_contiguous() for k, v in before.items()}
    moved1 = {k: (ref_steps[1][0][k] - init[k]).abs() for k in init}
    tight = total = 0
    for steps in (1, 2):
        want, rh = ref_steps[steps]
        got, th = acc.fit_detector(tm, steps=steps, device="cpu", **FIT)
        assert len(th) == len(rh) == steps
        np.testing.assert_allclose(th, rh, rtol=1e-5)
        assert list(got) == list(want) == sorted(init)
        for k in init:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == torch.float32
            diff = (got[k] - want[k]).abs()
            well = moved1[k] >= 0.99 * LR
            tight += int(well.sum())
            total += well.numel()
            if well.any():
                assert float(diff[well].max()) <= 1e-6, (k, steps)
            assert float(diff.max()) <= 2 * _adam_travel(steps), (k, steps)
        for k in ("priors0", "priors1", "prior_concat"):
            torch.testing.assert_close(got[k], init[k], rtol=0, atol=0)
        # the model the caller passed is left as it was
        for k, v in tm.ir.params.items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
            assert v.is_contiguous() == formats[k] and not v.requires_grad
    assert tight >= 0.05 * total, (tight, total)


def test_the_nhwc_plan_fits_channels_last_weights(ir_root):
    """The nhwc plan stores its full convolutions' weights channels_last
    (conv0's 3×3 kernel); the fit's copy keeps them so and steps them."""
    tm = _port_model(ir_root, "nhwc")
    w = tm.ir.params["conv0_w"]
    assert not w.is_contiguous() and w.is_contiguous(
        memory_format=torch.channels_last)
    net, params = acc._trainable_copy(tm.module, torch.device("cpu"), KEY)
    trained = net.ir.params
    assert [p.data_ptr() for p in params] == [
        v.data_ptr() for v in trained.values()]
    assert all(p.is_leaf and p.requires_grad for p in params)
    assert trained["conv0_w"].is_contiguous(memory_format=torch.channels_last)
    assert not tm.ir.params["conv0_w"].requires_grad


def test_ir_fit_fits_a_float32_copy_of_a_bfloat16_model(ir_root):
    tm = ModelRegistry(dtype="bfloat16", device="cpu",
                       models_dir=ir_root).get(KEY)
    before = copy.deepcopy(tm.ir.params)
    state, history = acc.fit_detector(tm, steps=2, n_scenes=2, batch=2,
                                      device="cpu")
    assert len(history) == 2 and all(np.isfinite(history))
    assert list(state) == sorted(before)
    assert {v.dtype for v in state.values()} == {torch.float32}
    for k, v in tm.ir.params.items():
        assert v.dtype == torch.bfloat16
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_ir_fit_runs_on_the_card_unless_asked(ir_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acc.fit_detector(_port_model(ir_root), steps=1, n_scenes=2, batch=2)


def test_flat_writer_rejects_what_is_not_a_flat_weight_dict():
    with pytest.raises(ValueError, match="not a flat weight dict"):
        flat_to_msgpack({"a": {"b": torch.zeros(2)}})
    with pytest.raises(ValueError, match="not a flat weight dict"):
        flat_to_msgpack({"a": 1.0})
    flat = {"b_w": torch.arange(6.0).reshape(2, 3), "a_b": torch.ones(1)}
    back = flat_from_msgpack(flat_to_msgpack(flat))
    assert list(back) == ["b_w", "a_b"]
    for k in flat:
        torch.testing.assert_close(back[k], flat[k], rtol=0, atol=0)


# ------------------------------------------- fitted, saved and served


@pytest.fixture(scope="module")
def fitted_ir(ir_root):
    """A 40-step port fit through the IR: its flat dict and history."""
    state, history = acc.fit_detector(_port_model(ir_root), steps=40,
                                      n_scenes=16, device="cpu")
    assert all(np.isfinite(history)) and history[-1] < history[0]
    return state


def _numpy_tree(state):
    return {k: v.numpy() for k, v in state.items()}


def test_save_fitted_writes_the_references_bytes_for_an_ir(fitted_ir,
                                                           tmp_path):
    port_path = acc.save_fitted(fitted_ir, KEY, tmp_path / "port")
    ref_path = ref.save_fitted(jax.tree.map(np.asarray, _numpy_tree(
        fitted_ir)), KEY, tmp_path / "ref")
    assert port_path.read_bytes() == ref_path.read_bytes()


def test_each_registry_loads_the_others_ir_override(fitted_ir,
                                                    tmp_path_factory):
    port_root = _write_ir(tmp_path_factory.mktemp("port_saved"))
    ref_root = _write_ir(tmp_path_factory.mktemp("ref_saved"))
    acc.save_fitted(fitted_ir, KEY, port_root)
    ref.save_fitted(_numpy_tree(fitted_ir), KEY, ref_root)
    jm = JaxRegistry(dtype="float32", models_dir=str(port_root)).get(KEY)
    tm = ModelRegistry(dtype="float32", device="cpu",
                       models_dir=ref_root).get(KEY)
    assert jm.weight_source == tm.weight_source == "ir-bin+override"
    assert list(jm.params) == list(tm.ir.params)
    for k, v in tm.ir.params.items():
        np.testing.assert_array_equal(np.asarray(jm.params[k]),
                                      fitted_ir[k].numpy())
        torch.testing.assert_close(v.contiguous(), fitted_ir[k], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("plan", ["nhwc", "nchw"])
def test_fitted_ir_serves_alike_in_both_packages(fitted_ir, tmp_path, plan):
    root = _write_ir(tmp_path)
    acc.save_fitted(fitted_ir, KEY, root)
    jm = JaxRegistry(dtype="float32", models_dir=str(root)).get(KEY)
    tm = _port_model(root, plan)
    assert tm.weight_source == "ir-bin+override"
    scenes = acc.holdout_scenes()
    wire = np.stack([bgr_to_i420_host(s.frame) for s in scenes])
    kw = dict(max_detections=16, score_threshold=0.3, wire_format="i420")
    want = np.asarray(jax.jit(jax_detect_step(jm, **kw))(jm.params, wire))
    got = build_detect_step(tm, **kw)(torch.from_numpy(wire)).numpy()
    assert got.shape == want.shape == (8, 16, 7)
    assert (want[..., 6] > 0.5).any()
    np.testing.assert_array_equal(got[..., 5:], want[..., 5:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert acc.evaluate_packed(got, scenes) == ref.evaluate_packed(want,
                                                                   scenes)

