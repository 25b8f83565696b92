"""The int8 GEMM's plain version against the Pallas kernel, and the
int8 ops against ``evam_tpu.ops.qlinear``.

The Pallas kernel runs in interpret mode on the CPU, as the reference's
own tests run it. The CUDA kernel cannot run on the CPU; ``chip_smoke.py``
holds it against the plain version on the card.

Tolerances: rtol = atol = 2e-5 on outputs, the pin of
``tests/test_quant.py::TestPallasQGemm``; int8 codes equal exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evam_tpu.ops import qlinear as jql
from evam_tpu.ops.pallas_qgemm import _qgemm, pallas_quant_dense
from evam_tpu_torch.ops import qgemm as tqg
from evam_tpu_torch.ops import qlinear as tql

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _operands(m, k, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 2).astype(dtype)
    w = (rng.normal(size=(k, n)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return x, w, b


def _port(x, w, b):
    """The port's call: weights quantized once, [N, K] K-contiguous."""
    wq, w_scale = tql.quantize_weight(torch.from_numpy(w))
    bias = None if b is None else torch.from_numpy(b)
    return tqg.qgemm(torch.from_numpy(x), wq.T.contiguous(), w_scale, bias)


def _pallas_codes(x):
    """The Pallas kernel's int8 codes: with identity weights and unit
    weight scales it writes ``float(code) * row_scale``."""
    m, k = x.shape
    pm, pk = -(-m // 8) * 8, -(-k // 128) * 128
    xp = jnp.pad(jnp.asarray(x), ((0, pm - m), (0, pk - k)))
    eye = jnp.eye(pk, dtype=jnp.int8)
    out = _qgemm(xp, eye, jnp.ones((1, pk), jnp.float32), tile_m=min(128, pm),
                 tile_n=128, interpret=True)
    return np.asarray(out)[:m, :k]


@pytest.mark.parametrize("m,k,n", [(48, 64, 96), (130, 32, 130), (8, 256, 16)])
def test_plain_matches_pallas_interpret(m, k, n):
    x, w, b = _operands(m, k, n, seed=m)
    ref = pallas_quant_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             interpret=True)
    got = _port(x, w, b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_codes_equal_the_pallas_kernels(dtype):
    x, _, _ = _operands(40, 96, 8, seed=3)
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    else:
        xt = torch.from_numpy(x)
    codes, row_scale = tqg.quantize_rows(xt)
    pallas = _pallas_codes(x)
    s = row_scale.numpy()[:, None]
    recovered = np.rint(pallas / s).astype(np.int32)
    np.testing.assert_array_equal(recovered, codes.numpy().astype(np.int32))
    # and the scales: code * scale reproduces the kernel's product
    np.testing.assert_array_equal(
        pallas, (codes.numpy().astype(np.float32) * s).astype(np.float32))


def test_ragged_shapes():
    """The 130x32x130 case of tests/test_quant.py: m and n off the tiles."""
    x, w, _ = _operands(130, 32, 130, seed=1)
    ref = pallas_quant_dense(jnp.asarray(x), jnp.asarray(w), None,
                             interpret=True)
    np.testing.assert_allclose(_port(x, w, None).numpy(), np.asarray(ref), **TOL)


def test_m_zero():
    x, w, b = _operands(0, 32, 24, seed=2)
    ref = pallas_quant_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = _port(x, w, b)
    assert tuple(got.shape) == (0, 24) == ref.shape
    got = _port(x, w, None)
    assert tuple(got.shape) == (0, 24)


def test_bf16_input():
    x, w, b = _operands(64, 128, 32, seed=4)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = pallas_quant_dense(xb, jnp.asarray(w), jnp.asarray(b), interpret=True)
    wq, w_scale = tql.quantize_weight(torch.from_numpy(w))
    got = tqg.qgemm(torch.from_numpy(x).to(torch.bfloat16), wq.T.contiguous(),
                    w_scale, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_quantize_weight_matches_reference():
    w = np.random.default_rng(5).normal(size=(3, 3, 16, 24)).astype(np.float32)
    ref_q, ref_s = jql.quantize_weight(jnp.asarray(w))
    got_q, got_s = tql.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    # torch's OIHW layout gives the same codes
    oihw_q, oihw_s = tql.quantize_weight(
        torch.from_numpy(w).permute(3, 2, 0, 1), out_axis=0)
    np.testing.assert_array_equal(oihw_q.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(ref_q))
    np.testing.assert_array_equal(oihw_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("kernel,strides,groups", [
    ((1, 1), (1, 1), 1), ((3, 3), (1, 1), 1), ((3, 3), (2, 2), 1),
    ((1, 1), (2, 2), 1), ((3, 3), (1, 1), 4),
])
def test_quant_conv_matches_reference(monkeypatch, backend, kernel, strides,
                                      groups):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", backend)
    monkeypatch.setattr(tql, "QGEMM_BACKEND", backend)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    w = (rng.normal(size=kernel + (16 // groups, 24)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(24,)) * 0.1).astype(np.float32)
    ref = jql.quant_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         strides=strides, feature_group_count=groups)
    got = tql.quant_conv(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), strides=strides,
                         feature_group_count=groups)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_quant_dense_matches_reference(monkeypatch, backend):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", backend)
    monkeypatch.setattr(tql, "QGEMM_BACKEND", backend)
    x, w, b = _operands(12, 40, 20, seed=7)
    ref = jql.quant_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tql.quant_dense(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_backends_differ_as_in_the_reference(monkeypatch):
    """Per-pixel (pallas) and per-example (xla) scales give different
    int8 outputs for a 1x1 conv — the knob is not numerics-neutral in
    either package."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 4, 4, 32)).astype(np.float32)
    x[:, 0, 0] *= 50  # one loud pixel coarsens the per-example scale
    w = (rng.normal(size=(1, 1, 32, 8)) * 0.2).astype(np.float32)
    outs = {}
    for backend in ("xla", "pallas"):
        monkeypatch.setattr(tql, "QGEMM_BACKEND", backend)
        outs[backend] = tql.quant_conv(torch.from_numpy(x),
                                       torch.from_numpy(w), None).numpy()
    assert not np.allclose(outs["xla"], outs["pallas"], rtol=1e-4, atol=1e-4)


def test_cpu_tensor_takes_the_plain_path():
    tqg.launches = 0
    x, w, b = _operands(33, 64, 16, seed=9)
    wq, w_scale = tql.quantize_weight(torch.from_numpy(w))
    out, codes, scales = tqg.qgemm(torch.from_numpy(x), wq.T.contiguous(),
                                   w_scale, torch.from_numpy(b),
                                   return_codes=True)
    ref = tqg.qgemm_reference(torch.from_numpy(x), wq.T.contiguous(), w_scale,
                              torch.from_numpy(b))
    assert torch.equal(out, ref)
    ref_codes, ref_scales = tqg.quantize_rows(torch.from_numpy(x))
    assert torch.equal(codes, ref_codes) and torch.equal(scales, ref_scales)
    assert tqg.launches == 0


def test_wrapper_checks_operands():
    x = torch.zeros((4, 8))
    wq = torch.zeros((3, 8), dtype=torch.int8)
    s = torch.ones(3)
    with pytest.raises(TypeError):
        tqg.qgemm(x.double(), wq, s)
    with pytest.raises(TypeError):
        tqg.qgemm(x, wq.float(), s)
    with pytest.raises(ValueError):
        tqg.qgemm(x, torch.zeros((3, 9), dtype=torch.int8), s)
    with pytest.raises(ValueError):
        tqg.qgemm(x, wq, torch.ones(4))
    with pytest.raises(ValueError):
        tqg.qgemm(x, wq, s, torch.ones(2))


def test_kernel_source_is_built_without_fast_math():
    from evam_tpu_torch.ops import kernels

    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.library_path("qgemm").parent == kernels.BUILD_DIR
    assert (kernels.CSRC / kernels.SOURCES["qgemm"]).is_file()
