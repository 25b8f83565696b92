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
from chip_smoke import IMAGES, MAIN_SHAPES, RAGGED_SHAPES
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

    flags = kernels.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    # IEEE division, denormals kept, no multiply-add contraction
    assert {"--prec-div=true", "--ftz=false", "--fmad=false"} <= set(flags)
    assert not {"--prec-div=false", "--ftz=true", "--fmad=true",
                "-prec-div=false", "-ftz=true", "-fmad=true"} & set(flags)
    # every flag is one of these: target, language, optimisation, shared
    # library, and the three above
    assert set(flags) <= {
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "--prec-div=true", "--ftz=false",
        "--fmad=false"}
    assert kernels.library_path("qgemm").parent == kernels.BUILD_DIR
    assert (kernels.CSRC / kernels.SOURCES["qgemm"]).is_file()


# --- the launch plan (ops/qgemm.py::plan), which the CUDA entry takes as is

MAIN = [(m * IMAGES, k, n) for m, k, n in MAIN_SHAPES]
RAGGED = [(m, k, n, dt) for m, k, n, dt in RAGGED_SHAPES if m]
PLAN_CASES = ([(m, k, n, "bfloat16") for m, k, n in MAIN] + RAGGED)


@pytest.mark.parametrize("m,k,n,dtype", PLAN_CASES)
def test_plan_covers_every_output_once(m, k, n, dtype):
    p = tqg.plan(m, n, k, getattr(torch, dtype))
    assert (p.bm, p.bn) in tqg.TILES
    # row block bx takes row tiles bx, bx + grid[0], ... (csrc/qgemm.cu)
    # and column block by the column tiles by * nsub, ... (at most nsub)
    mtiles, ntiles = -(-m // p.bm), -(-n // p.bn)
    assert 1 <= p.grid[0] <= mtiles
    assert p.grid[1] == -(-ntiles // p.nsub)
    hits = np.zeros((mtiles * p.bm, ntiles * p.bn), np.int8)
    for bx in range(p.grid[0]):
        for mt in range(bx, mtiles, p.grid[0]):
            for by in range(p.grid[1]):
                for nt in range(by * p.nsub, min((by + 1) * p.nsub, ntiles)):
                    hits[mt * p.bm:(mt + 1) * p.bm,
                         nt * p.bn:(nt + 1) * p.bn] += 1
    assert (hits == 1).all()
    assert (mtiles - 1) * p.bm < m and (ntiles - 1) * p.bn < n
    # K chunks of whole k-steps cover K
    assert p.kc % 32 == 0 and p.kc >= 32
    assert -(-k // p.kc) * p.kc >= k


@pytest.mark.parametrize("m,k,n,dtype", PLAN_CASES)
def test_plan_fits_and_fills_the_card(m, k, n, dtype):
    p = tqg.plan(m, n, k, getattr(torch, dtype))
    esize = 2 if dtype == "bfloat16" else 4
    kp = -(-k // 32) * 32
    # x buffers: two where K is in chunks or a block has several row
    # tiles; weight buffers: two where K is in chunks or a block has
    # several column tiles (csrc/qgemm.cu)
    chunked = p.kc < kp
    bufs = (2 if chunked or p.grid[0] < -(-m // p.bm) else 1,
            2 if chunked or p.nsub > 1 else 1)
    assert not chunked or p.nsub == 1
    assert p.smem == tqg.smem_bytes(p.bm, p.bn, p.kc, esize, *bufs)
    assert p.smem <= 232448
    if m * n / (16 * 8) >= 132:
        assert p.blocks >= 132, p


@pytest.mark.parametrize("m,k,n", MAIN)
def test_main_shapes_take_the_aligned_variant(m, k, n):
    p = tqg.plan(m, n, k, torch.bfloat16)
    assert p.variant == "aligned" and not p.masked
    # K whole in shared memory: each row quantized once per block
    assert p.kc >= k
    # large M: all of N (<= 128) in one block
    if m >= 32768:
        assert p.bn * p.nsub >= n and p.grid[1] == 1


def test_ragged_shapes_reach_every_edge_of_the_tiling():
    """chip_smoke.py's ragged shapes: K off 32, K = 2048 held whole and
    in chunks (bf16 and float32), N > 512, N off 8, M < 16, M off the
    row tile — the masked and aligned variants both, and a masked plan
    whose blocks walk several row tiles."""
    plans = {(m, k, n, dt): tqg.plan(m, n, k, getattr(torch, dt))
             for m, k, n, dt in RAGGED}
    assert any(k % 32 for m, k, n, dt in plans)
    assert any(n > 512 for m, k, n, dt in plans)
    assert any(n % 8 for m, k, n, dt in plans)
    assert any(m < 16 for m, k, n, dt in plans)
    assert any(m % p.bm for (m, k, n, dt), p in plans.items())
    assert any(k == 2048 and p.kc < k and dt == "bfloat16"
               for (m, k, n, dt), p in plans.items())
    assert any(k == 2048 and p.kc < k and dt == "float32"
               for (m, k, n, dt), p in plans.items())
    assert any(k == 2048 and p.kc >= k for (m, k, n, dt), p in plans.items())
    assert {p.variant for p in plans.values()} == {"aligned", "masked"}
    assert any(p.masked and p.grid[0] < -(-m // p.bm)
               for (m, k, n, dt), p in plans.items())
    assert any(dt == "float32" and p.masked for (m, k, n, dt), p in plans.items())


def test_unaligned_pointers_take_the_masked_variant():
    assert tqg.plan(1024, 64, 64, torch.bfloat16).variant == "aligned"
    p = tqg.plan(1024, 64, 64, torch.bfloat16, pointers_aligned=False)
    assert p.variant == "masked"


def test_plan_chunks_k_only_where_it_does_not_fit():
    for m, k, n, dt in PLAN_CASES:
        p = tqg.plan(m, n, k, getattr(torch, dt))
        esize = 2 if dt == "bfloat16" else 4
        kp = -(-k // 32) * 32
        if p.kc < kp:
            assert tqg.smem_bytes(p.bm, p.bn, kp, esize, 1, 1) > tqg.SMEM_SOFT
            assert p.smem <= tqg.SMEM_SOFT


def _fast_codes(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The kernel's quantization rule (csrc/qgemm.cu ``quantize``) in
    numpy float32: round x * (1 / scale) through the float adder, and
    divide where that product lies within 1e-4 of a half-integer."""
    f32 = np.float32
    inv = (f32(1) / scale).astype(f32)[:, None]
    y = (x * inv).astype(f32)
    t = (y + f32(12582912.0)).astype(f32)
    d = (y - (t - f32(12582912.0))).astype(f32)
    q = t.view(np.int32) - 0x4B400000
    slow = ~(np.abs(d) <= f32(0.4999))
    exact = np.rint((x.astype(np.float64) / scale[:, None]).astype(f32))
    q = np.where(slow, np.clip(exact, -127, 127), q)
    return q.astype(np.int32), slow


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_quantization_rule_equals_division(seed):
    """The product with the reciprocal, rounded through the adder, gives
    the IEEE quotient's codes; near half-integers it divides."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64, 4096)) * 10.0 ** rng.uniform(-6, 3, (64, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0                                   # scale floor 1e-8
    x[1, :8] = [127, -127, 0.5, -0.5, 1.5, 2.5, 126.5, -126.5]  # ties
    x[2] = np.float32(1e-9) * np.arange(4096, dtype=np.float32)  # tiny
    codes, scale = tqg.quantize_rows(torch.from_numpy(x))
    got, slow = _fast_codes(x, scale.numpy())
    np.testing.assert_array_equal(got, codes.numpy().astype(np.int32))
    assert np.abs(got).max() <= 127
    assert slow.mean() < 1e-3   # the division is rare


def test_plain_matches_pallas_interpret_at_k_2048():
    """The zoo's largest K, in the Pallas kernel's interpret mode."""
    x, w, b = _operands(16, 2048, 16, seed=11)
    ref = pallas_quant_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             interpret=True)
    got = _port(x, w, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    codes, _ = tqg.quantize_rows(torch.from_numpy(x))
    pallas = _pallas_codes(x)
    np.testing.assert_array_equal(
        np.rint(pallas / tqg.quantize_rows(torch.from_numpy(x))[1].numpy()[:, None]),
        codes.numpy())
