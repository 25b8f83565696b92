// Int8 GEMM with fused dynamic per-row activation quantization.
//
// Replaces evam_tpu/ops/pallas_qgemm.py::_qgemm_kernel (the Pallas TPU
// kernel behind pallas_quant_dense). For x [M, K] (bf16 or f32) and
// weights quantized per output channel, stored int8 [N, K] with K
// contiguous (transposed once at load), it computes
//
//   row_scale[m] = max(max_k |x[m, k]| / 127, 1e-8)
//   xq[m, k]     = clamp(round_half_even(x[m, k] / row_scale[m]), -127, 127)
//   out[m, n]    = float(sum_k xq[m, k] * wq[n, k]) * row_scale[m] * w_scale[n]
//                  (+ bias[n])
//
// in that order of operations, each rounded once, so it equals the plain
// version (evam_tpu_torch/ops/qgemm.py::qgemm_reference) bit for bit.
// The source must be compiled WITHOUT --use_fast_math: the codes match
// only with IEEE division (__fdiv_rn) and the epilogue only without FMA
// contraction (__fmul_rn / __fadd_rn).
//
// Design (a first, simple kernel): one 256-thread block computes a 64x64
// output tile. A prologue takes each of its 64 rows' abs-max over the
// full K (a warp per row) into shared memory; the TPU kernel holds the
// whole (tile, K) block in VMEM, here K is swept twice instead. The main
// loop walks K in chunks of 32: the x chunk is quantized into shared
// memory as packed int8x4 words, the weight chunk is copied beside it,
// and each thread accumulates a 4x4 sub-tile of int32 sums with __dp4a.
// Ragged M, N and K edges are zero-filled and masked. Each N-block
// recomputes its rows' abs-max and codes: a cost of N/64 passes over x.
//
// What bounds it: at the SSD-512 shapes (K, N <= 512) this is far below
// the int8 ridge of the card — about 6 MB of bf16 read and 16 MB of f32
// written per 512x512 image against a few hundred MOPs — so it is bound
// by memory traffic. wgmma, TMA and a fused bf16/ReLU6 epilogue that
// writes half the bytes are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int KW = BK / 4;   // packed int8x4 words per row of a K chunk
constexpr int LDW = KW + 1;  // padded shared-memory row stride (banks)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ w_scale,
             const float* __restrict__ bias, float* __restrict__ out,
             int8_t* __restrict__ codes_out, float* __restrict__ scale_out,
             int M, int N, int K) {
  __shared__ float s_scale[BM];
  __shared__ int s_a[BM * LDW];
  __shared__ int s_b[BN * LDW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool emit_codes = codes_out != nullptr && blockIdx.y == 0;

  // Prologue: per-row abs-max over the full K, one warp per row.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    float mx = 0.f;
    if (m < M) {
      const T* row = x + (size_t)m * K;
      for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(to_f32(row[k])));
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) {
      const float s = fmaxf(__fdiv_rn(mx, 127.f), 1e-8f);
      s_scale[r] = s;
      if (emit_codes && m < M) scale_out[m] = s;
    }
  }
  __syncthreads();

  // Loader mapping: each thread stages 8 consecutive k of one row of x
  // and of one row of wq per chunk.
  const int lr = tid >> 2;        // 0..63
  const int lk = (tid & 3) * 8;   // 0, 8, 16, 24
  const float my_scale = s_scale[lr];
  // Compute mapping: rows ty + 16 i, columns tx + 16 j.
  const int ty = tid >> 4;
  const int tx = tid & 15;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int m = m0 + lr;
      int packed[2] = {0, 0};
      if (m < M) {
        const T* row = x + (size_t)m * K + k0 + lk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + lk + j < K) {
            int q = __float2int_rn(__fdiv_rn(to_f32(row[j]), my_scale));
            q = max(-127, min(127, q));
            packed[j >> 2] |= (q & 0xff) << (8 * (j & 3));
            if (emit_codes) codes_out[(size_t)m * K + k0 + lk + j] = (int8_t)q;
          }
        }
      }
      s_a[lr * LDW + (lk >> 2)] = packed[0];
      s_a[lr * LDW + (lk >> 2) + 1] = packed[1];
    }
    {
      const int n = n0 + lr;
      int packed[2] = {0, 0};
      if (n < N) {
        const int8_t* row = wq + (size_t)n * K + k0 + lk;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + lk + j < K)
            packed[j >> 2] |= ((int)(uint8_t)row[j]) << (8 * (j & 3));
        }
      }
      s_b[lr * LDW + (lk >> 2)] = packed[0];
      s_b[lr * LDW + (lk >> 2) + 1] = packed[1];
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[(ty + 16 * i) * LDW + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_b[(tx + 16 * j) * LDW + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: (float)acc * row_scale * w_scale (+ bias), one rounding each.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = s_scale[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), w_scale[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError().
// x: [M, K] bf16 (x_is_bf16 = 1) or f32; wq: [N, K] int8; w_scale: [N]
// f32; bias: [N] f32 or null; out: [M, N] f32. codes_out ([M, K] int8)
// and scale_out ([M] f32) are null, or receive the quantized rows.
int evam_qgemm(const void* x, int x_is_bf16, const void* wq,
               const void* w_scale, const void* bias, void* out,
               void* codes_out, void* scale_out, int M, int N, int K,
               void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    qgemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(w_scale), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<int8_t*>(codes_out),
        static_cast<float*>(scale_out), M, N, K);
  } else {
    qgemm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(wq),
        static_cast<const float*>(w_scale), static_cast<const float*>(bias),
        static_cast<float*>(out), static_cast<int8_t*>(codes_out),
        static_cast<float*>(scale_out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* evam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
