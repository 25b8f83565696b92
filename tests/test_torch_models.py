"""The port's SSD detector and registry against ``evam_tpu.models``.

Weights are bridged both ways: the reference's ``weights.msgpack``
(``ModelRegistry.save_weights``) loaded by the port's registry, and
the direct numpy handoff through ``models/convert.py::params_from_jax``.

Tolerances on ``loc``/``conf``:

* ``quant=False`` at float32: rtol = atol = 1e-4;
* ``quant=True`` with ``EVAM_QGEMM=pallas`` at float32: max abs diff
  ≤ 1e-2 × max |ref| — one int8 code can flip where the two frameworks'
  float sums differ in the last bit; the share of elements within 1e-4
  is reported and held ≥ 0.9.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import (
    MissingWeightsError,
    ModelRegistry,
    _seed_for,
)
from evam_tpu_torch.models.zoo.layers import QuantConv, quantize_model
from evam_tpu_torch.ops import qlinear as tql

torch.set_num_threads(1)
KEY = "object_detection/person_vehicle_bike"
SMALL = dict(input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8},
             allow_random_weights=True)


def _frames(seed=0, n=2):
    return np.random.default_rng(seed).uniform(0, 255, (n, 64, 64, 3)).astype(
        np.float32)


def _compare(jm, tm, x):
    """loc/conf of both models on x, each cast to its model's dtype."""
    jdtype = jax.tree.leaves(jm.params)[0].dtype
    ref = jax.jit(jm.forward)(jm.params, jax.numpy.asarray(x, jdtype))
    tdtype = next(tm.module.parameters()).dtype
    with torch.inference_mode():
        got = tm.forward(torch.from_numpy(x).to(tdtype))
    return ({k: np.asarray(ref[k], np.float32) for k in ("loc", "conf")},
            {k: got[k].float().numpy() for k in ("loc", "conf")})


def _bridge(jm, tm):
    tm.module.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           jm.params)))
    quantize_model(tm.module)


def test_float_ssd_matches_reference_via_params_from_jax():
    jm = JaxRegistry(dtype="float32", precision="FP32", **SMALL).get(KEY)
    tm = ModelRegistry(dtype="float32", precision="FP32", device="cpu",
                       **SMALL).get(KEY)
    _bridge(jm, tm)
    ref, got = _compare(jm, tm, _frames())
    for k in ("loc", "conf"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4)


def test_int8_pallas_ssd_matches_reference(monkeypatch):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jm = JaxRegistry(dtype="float32", precision="INT8", **SMALL).get(KEY)
    tm = ModelRegistry(dtype="float32", precision="INT8", device="cpu",
                       **SMALL).get(KEY)
    assert jm.module.quant and tm.module.quant
    _bridge(jm, tm)
    ref, got = _compare(jm, tm, _frames(1))
    for k in ("loc", "conf"):
        diff = np.abs(got[k] - ref[k])
        share = float((diff <= 1e-4).mean())
        print(f"{k}: max abs diff {diff.max():.3g}, max |ref| "
              f"{np.abs(ref[k]).max():.3g}, share within 1e-4 {share:.4f}")
        assert diff.max() <= 1e-2 * np.abs(ref[k]).max()
        assert share >= 0.9


def test_msgpack_weights_load_into_the_port(tmp_path):
    """INT8 registry: the reference saves bf16 params as msgpack, the
    port's registry reads them from the same models-dir layout."""
    jreg = JaxRegistry(models_dir=tmp_path, dtype="int8", **SMALL)
    jm = jreg.get(KEY)
    path = jreg.save_weights(KEY)
    assert path == tmp_path / KEY / "INT8" / "weights.msgpack"
    treg = ModelRegistry(models_dir=tmp_path, dtype="int8", device="cpu",
                         **SMALL)
    tm = treg.get(KEY)
    assert tm.weight_source == "msgpack"
    sd = tm.module.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(jm.params)[0]
    assert len(flat) == len(sd)
    for p, v in flat:
        name = ".".join(k.key for k in p)
        name = name[: -len("kernel")] + "weight" if name.endswith("kernel") else name
        v = np.asarray(v.astype(np.float32))
        t = sd[name].float().numpy()
        if t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(t, v)
    assert sd[name].dtype == torch.bfloat16


def test_int8_bf16_forward_agrees_via_msgpack(tmp_path, monkeypatch):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jreg = JaxRegistry(models_dir=tmp_path, dtype="int8", **SMALL)
    jm = jreg.get(KEY)
    jreg.save_weights(KEY)
    tm = ModelRegistry(models_dir=tmp_path, dtype="int8", device="cpu",
                       **SMALL).get(KEY)
    ref, got = _compare(jm, tm, _frames(2))
    for k in ("loc", "conf"):
        # bf16 activations: the frameworks round convolution sums to
        # bf16 at different points, so the tolerance is bf16's
        assert np.abs(got[k] - ref[k]).max() <= 5e-2 * np.abs(ref[k]).max()


def test_missing_weights_is_loud(tmp_path):
    reg = ModelRegistry(models_dir=tmp_path, device="cpu",
                        allow_random_weights=False)
    with pytest.raises(MissingWeightsError, match="weights.msgpack"):
        reg.get(KEY)


def test_random_weights_are_seeded_and_reported():
    a = ModelRegistry(device="cpu", dtype="float32", **SMALL).get(KEY)
    b = ModelRegistry(device="cpu", dtype="float32", **SMALL).get(KEY)
    assert a.weight_source == b.weight_source == "random"
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert _seed_for(KEY) == int.from_bytes(
        __import__("hashlib").sha256(KEY.encode()).digest()[:4], "little")


@pytest.mark.parametrize("alias", ["int8", "FP32-INT8", "fp16-int8", "bf16-int8"])
def test_int8_aliases_select_the_quant_variant(alias):
    reg = ModelRegistry(device="cpu", dtype=alias, **SMALL)
    assert reg.precision == "INT8" and reg.dtype == "bfloat16"
    m = reg.get(KEY)
    quant = [mod for mod in m.module.modules() if isinstance(mod, QuantConv)]
    assert len(quant) == 13  # 1 stem + 8 pointwise + 4 extra-level convs
    assert all(q.wq is not None and q.wq.dtype == torch.int8 for q in quant)
    jreg = JaxRegistry(dtype=alias, **SMALL)
    assert (jreg.precision, jreg.dtype) == (reg.precision, reg.dtype)


def test_precision_reads_evam_precision(monkeypatch):
    monkeypatch.setenv("EVAM_PRECISION", "int8")
    assert ModelRegistry(device="cpu", **SMALL).precision == "INT8"
    monkeypatch.setenv("EVAM_PRECISION", "float32")
    assert ModelRegistry(device="cpu", **SMALL).dtype == "float32"


def test_later_families_raise():
    reg = ModelRegistry(device="cpu", **SMALL)
    with pytest.raises(NotImplementedError, match="slice 5"):
        reg.get("action_recognition/encoder")
    with pytest.raises(KeyError):
        reg.get("no/such_model")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRegistry(**SMALL)


def test_anchor_table_matches_the_head_rows():
    m = ModelRegistry(device="cpu", **SMALL).get(KEY)
    with torch.inference_mode():
        out = m.forward(torch.zeros((1, 64, 64, 3), dtype=torch.bfloat16))
    assert out["loc"].shape[1] == out["conf"].shape[1] == len(m.anchors)
    jm = JaxRegistry(**SMALL).get(KEY)
    np.testing.assert_array_equal(m.anchors, jm.anchors)
