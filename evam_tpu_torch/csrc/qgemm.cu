// Int8 GEMM with fused dynamic per-row activation quantization, for Hopper.
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
// What bounds it. At the ten shapes of one 8-image SSD-512 forward
// (K <= 512, N <= 512) the kernel moves about 180 MB (bf16 x in, f32 out;
// the output is 80 % of it) for 7.1 G int8 operations: 0.053 ms of bytes
// at the H100's 3.35 TB/s against 0.004 ms at its int8 tensor-core peak.
// It is bound by bytes. The first design (a 64 x 64 tile per block,
// __dp4a on scalar loads) lost time in four places; what this one does:
//  1. Each row is quantized once per block, not once per 64 columns. A
//     block copies its (BM, K) x tile into shared memory with cp.async
//     (16 B a thread), takes each row's abs-max there (bf16 pairs, then
//     shuffles among the THREADS / BM threads of a row) and writes the
//     int8 codes once into a shared (BM, K) buffer. The block then
//     covers up to four 64-column tiles with those codes, streaming
//     their weight tiles through two cp.async buffers (the first lands
//     while the rows are quantized). Where the tile
//     cannot hold K (K in the thousands), K is cut into double-buffered
//     chunks: a first sweep of the rows takes the abs-max, the chunks
//     are quantized from the second sweep, which the 50 MB L2 serves.
//     The quantization divides rarely: x * (1 / scale) rounded through
//     the float adder gives the IEEE quotient's code except within 1e-4
//     of a half-integer, where it divides (see quantize()).
//  2. The product runs on the int8 tensor cores: mma.sync m16n8k32 s8
//     (inline PTX), both operands K-major as stored, fragments read with
//     32-bit shared loads from rows padded by 16 B (no bank conflicts),
//     on eight warps a block; a warp with few fragments alternates its
//     k-steps between two sets of sums, so two products are in flight.
//     mma.sync, not wgmma: at 7.1 GOPs a forward the tensor cores are
//     off the critical path either way, and its register fragments allow
//     the 16-row tiles that the small-M shapes need.
//  3. The card is kept full at every shape. The launch plan (ops/qgemm.py
//     ::plan) picks 64, 32 or 16 rows (a 16 KB x tile) and the column
//     tiles per block so that the grid has at least 132 blocks; where it
//     has more than four per SM, each block walks several row tiles and
//     copies the next tile's x in while it quantizes, multiplies and
//     stores the current one. With N split across blocks, each block
//     quantizes its rows again, from L2: x is <= 2 MB at those shapes.
//  4. The f32 output is stored as float2 straight from the accumulator
//     fragments: each warp store writes 8 rows x 32 contiguous bytes
//     (whole 32-byte sectors).
// Shapes off the aligned path's preconditions (M or N not a multiple of
// the tile, K not a multiple of 32, operands not 16-byte aligned) take
// the masked variant of the same kernel: guarded loads zero-fill the
// edges, guarded stores drop them. The wrapper picks by shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 16;            // bytes added to each shared row
constexpr int SMEM_MAX = 232448;   // a block's shared memory on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Eight consecutive elements from 16-byte aligned shared memory.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x, f[2 * j + 1] = v.y;
  }
}

// max |v| over eight elements (bf16: exact in pairs, then widened).
__device__ __forceinline__ float abs_max8(const float* p, float mx) {
  float f[8];
  load8(p, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fabsf(f[j]));
  return mx;
}
__device__ __forceinline__ float abs_max8(const __nv_bfloat16* p, float mx) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162 m2 = __hmax2(__hmax2(__habs2(h[0]), __habs2(h[1])),
                                    __hmax2(__habs2(h[2]), __habs2(h[3])));
  const float2 f = __bfloat1622float2(m2);
  return fmaxf(mx, fmaxf(f.x, f.y));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rounding through the float adder, at full rate (F2I, I2F and FRND run
// at a quarter of it): for |y| < 2^22, y + 1.5 * 2^23 holds round(y),
// ties to even, in its low mantissa bits.
constexpr float MAGIC = 12582912.f;
constexpr int MAGIC_BITS = 0x4B400000;

// clamp(round_half_even(v / scale), -127, 127) with v / scale the IEEE
// quotient, mostly without dividing. y = v * (1 / scale), both rounded,
// is within 3 ulp(127) < 2.3e-5 of the IEEE quotient (|v / scale| <= 127
// by the choice of scale), so the two round to the same integer, within
// [-127, 127], unless y lies within that of a half-integer. Then, and
// for inf or nan, divide.
__device__ __forceinline__ int quantize(float v, float scale, float inv) {
  const float y = __fmul_rn(v, inv);
  const float t = __fadd_rn(y, MAGIC);
  const float d = __fsub_rn(y, __fsub_rn(t, MAGIC));  // y - round(y), exact
  if (fabsf(d) <= 0.4999f) return __float_as_int(t) - MAGIC_BITS;
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return max(-127, min(127, q));
}

// float(a): through the adder where |a| < 2^22 (exact), else I2F.
__device__ __forceinline__ float to_float(int a, bool small) {
  return small ? __fsub_rn(__int_as_float(a + MAGIC_BITS), MAGIC)
               : __int2float_rn(a);
}

// Shared-memory layout, in bytes; the host computes the same sum
// (ops/qgemm.py::smem_bytes): xbufs x and wbufs weight chunks, rows
// padded by PAD, then one codes chunk and the row scales.
struct Layout {
  int x_ld, c_ld, w_ld, x_bytes, w_bytes, c_bytes, total;
  __host__ __device__ Layout(int bm, int bn, int kc, int esize, int xbufs,
                             int wbufs) {
    x_ld = kc * esize + PAD;
    c_ld = kc + PAD;
    w_ld = kc + PAD;
    x_bytes = bm * x_ld;
    w_bytes = bn * w_ld;
    c_bytes = bm * c_ld;
    total = xbufs * x_bytes + wbufs * w_bytes + c_bytes + 4 * bm;
  }
};

// Copies the x rows [m0, m0 + BM) x [k0, k0 + kwp) and the weight rows
// [n0, n0 + BN) of the same K range into shared memory. Aligned: 16-byte
// cp.async. Masked: guarded loads, zero past M, N and K.
template <typename T, int BM, bool MASKED>
__device__ __forceinline__ void load_x(char* xs, int x_ld, const T* __restrict__ x,
                                       int M, int K, int m0, int k0, int kwp) {
  constexpr int E = 16 / sizeof(T);  // elements per 16 bytes
  const int vpr = kwp / E;
  for (int i = threadIdx.x; i < BM * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    char* dst = xs + r * x_ld + v * 16;
    const int m = m0 + r, k = k0 + v * E;
    if (!MASKED) {
      cp_async16(dst, x + (size_t)m * K + k);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int j = 0; j < E; ++j)
        d[j] = (m < M && k + j < K) ? x[(size_t)m * K + k + j] : zero<T>();
    }
  }
}

template <int BN, bool MASKED>
__device__ __forceinline__ void load_w(char* ws, int w_ld, const int8_t* __restrict__ wq,
                                       int N, int K, int n0, int k0, int kwp) {
  const int vpr = kwp / 16;
  for (int i = threadIdx.x; i < BN * vpr; i += THREADS) {
    const int r = i / vpr, v = i - r * vpr;
    char* dst = ws + r * w_ld + v * 16;
    const int n = n0 + r, k = k0 + v * 16;
    if (!MASKED) {
      cp_async16(dst, wq + (size_t)n * K + k);
    } else {
      int8_t* d = reinterpret_cast<int8_t*>(dst);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = (n < N && k + j < K) ? wq[(size_t)n * K + k + j] : int8_t(0);
    }
  }
}

// Quantizes the x chunk in shared memory into int8 codes. THREADS / BM
// threads share a row (neighbouring lanes), each taking vectors of 8
// elements. With `scale` null the chunk is the whole row: its abs-max is
// taken here first and the row scale written to s_scale (and scale_out).
template <typename T, int BM, bool MASKED>
__device__ __forceinline__ void quantize_chunk(
    const char* xs, int x_ld, char* cs, int c_ld, float* s_scale,
    bool whole_row, int8_t* __restrict__ codes_out,
    float* __restrict__ scale_out, int M, int K, int m0, int k0, int kwp) {
  constexpr int TPR = THREADS / BM;
  const int r = threadIdx.x / TPR, i = threadIdx.x % TPR;
  const T* row = reinterpret_cast<const T*>(xs + r * x_ld);
  const int nv = kwp / 8;
  const int m = m0 + r;
  float scale;
  if (whole_row) {
    float mx = 0.f;
    for (int v = i; v < nv; v += TPR) mx = abs_max8(row + v * 8, mx);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    scale = fmaxf(__fdiv_rn(mx, 127.f), 1e-8f);
    if (i == 0) {
      s_scale[r] = scale;
      if (scale_out != nullptr && m < M) scale_out[m] = scale;
    }
  } else {
    scale = s_scale[r];
  }
  const float inv = __frcp_rn(scale);
  for (int v = i; v < nv; v += TPR) {
    float f[8];
    load8(row + v * 8, f);
    int q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = quantize(f[j], scale, inv);
    uint32_t packed[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      packed[h] = __byte_perm(__byte_perm(q[4 * h], q[4 * h + 1], 0x0040),
                              __byte_perm(q[4 * h + 2], q[4 * h + 3], 0x0040),
                              0x5410);
    *reinterpret_cast<uint2*>(cs + r * c_ld + v * 8) = make_uint2(packed[0], packed[1]);
    if (codes_out != nullptr && m < M) {
      const int k = k0 + v * 8;
      int8_t* dst = codes_out + (size_t)m * K + k;
      if (!MASKED) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k + j < K) dst[j] = (int8_t)(packed[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

// Warp layout of a BM x BN tile: WARPS_M x WARPS_N warps run the
// product, each on a (BM / WARPS_M) x (BN / WARPS_N) tile of m16n8
// fragments; the other warps only load and quantize.
template <int BM, int BN>
struct Warps {
  static constexpr int ALL = THREADS / 32;
  static constexpr int M = BM / 16 < ALL ? BM / 16 : ALL;
  static constexpr int N = (ALL / M) < BN / 8 ? ALL / M : BN / 8;
  static constexpr int MT = BM / M / 16;
  static constexpr int NT = BN / N / 8;
};

// acc += codes [BM, kwp] x weights [BN, kwp]^T, both K-major in shared
// memory, on the int8 tensor cores, one k-step of 32 at a time.
template <int BM, int BN>
__device__ __forceinline__ void mma_step(
    int (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4], const char* a_base,
    int c_ld, const char* b_base, int w_ld, int kk) {
  using W = Warps<BM, BN>;
  uint32_t a[W::MT][4];
#pragma unroll
  for (int i = 0; i < W::MT; ++i) {
    const char* p = a_base + i * 16 * c_ld + kk;
    a[i][0] = *reinterpret_cast<const uint32_t*>(p);
    a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * c_ld);
    a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * c_ld + 16);
  }
#pragma unroll
  for (int j = 0; j < W::NT; ++j) {
    const char* p = b_base + j * 8 * w_ld + kk;
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
    for (int i = 0; i < W::MT; ++i) mma_s8(acc[i][j], a[i], b0, b1);
  }
}

// Where a warp holds few fragments, the k-steps alternate between two
// sets of sums, so that two products are in flight; integer sums are
// exact in any order.
template <int BM, int BN>
__device__ __forceinline__ void mma_chunk(
    int (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4], const char* cs,
    int c_ld, const char* ws, int w_ld, int kwp, int wm, int wn, int g, int t) {
  using W = Warps<BM, BN>;
  const char* a_base = cs + (wm * W::MT * 16 + g) * c_ld + 4 * t;
  const char* b_base = ws + (wn * W::NT * 8 + g) * w_ld + 4 * t;
  int kk = 0;
  if (W::MT * W::NT <= 2) {
    int acc2[W::MT][W::NT][4] = {};
    for (; kk + 64 <= kwp; kk += 64) {
      mma_step<BM, BN>(acc, a_base, c_ld, b_base, w_ld, kk);
      mma_step<BM, BN>(acc2, a_base, c_ld, b_base, w_ld, kk + 32);
    }
#pragma unroll
    for (int i = 0; i < W::MT; ++i)
#pragma unroll
      for (int j = 0; j < W::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] += acc2[i][j][c];
  }
  for (; kk < kwp; kk += 32) mma_step<BM, BN>(acc, a_base, c_ld, b_base, w_ld, kk);
}

// out = float(acc) * row_scale * w_scale (+ bias), one rounding each,
// stored two columns (8 bytes) a thread.
template <int BM, int BN, bool MASKED>
__device__ __forceinline__ void epilogue(
    const int (&acc)[Warps<BM, BN>::MT][Warps<BM, BN>::NT][4],
    const float* s_scale, const float* __restrict__ w_scale,
    const float* __restrict__ bias, float* __restrict__ out, int M, int N,
    int m0, int n0, bool small, int wm, int wn, int g, int t) {
  using W = Warps<BM, BN>;
#pragma unroll
  for (int j = 0; j < W::NT; ++j) {
    const int n = n0 + (wn * W::NT + j) * 8 + 2 * t;
    float ws0 = 0.f, ws1 = 0.f, b0 = 0.f, b1 = 0.f;
    if (!MASKED) {
      const float2 s = *reinterpret_cast<const float2*>(w_scale + n);
      ws0 = s.x, ws1 = s.y;
      if (bias != nullptr) {
        const float2 b = *reinterpret_cast<const float2*>(bias + n);
        b0 = b.x, b1 = b.y;
      }
    } else {
      if (n < N) ws0 = w_scale[n], b0 = bias != nullptr ? bias[n] : 0.f;
      if (n + 1 < N) ws1 = w_scale[n + 1], b1 = bias != nullptr ? bias[n + 1] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < W::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * W::MT + i) * 16 + g + 8 * h;
        const int m = m0 + r;
        const float s = s_scale[r];
        float v0 = __fmul_rn(__fmul_rn(to_float(acc[i][j][2 * h], small), s), ws0);
        float v1 = __fmul_rn(__fmul_rn(to_float(acc[i][j][2 * h + 1], small), s), ws1);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, b0);
          v1 = __fadd_rn(v1, b1);
        }
        if (!MASKED) {
          *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0, v1);
        } else if (m < M) {
          if (n < N) out[(size_t)m * N + n] = v0;
          if (n + 1 < N) out[(size_t)m * N + n + 1] = v1;
        }
      }
    }
  }
}

// Block (bx, by) computes the row tiles bx, bx + gridDim.x, ... of the
// column tiles by * nsub, ..., by * nsub + nsub - 1 (those below N).
//  - K whole (kc >= K): per row tile, x is quantized once and multiplied
//    with each column tile's weights; the next step's x or weight tile
//    is copied in while the current one is multiplied and stored.
//  - K in chunks (nsub = 1): per row tile, a first sweep takes the rows'
//    abs-max, then x and weight chunks stream through two buffers each.
template <typename T, int BM, int BN, bool MASKED>
__global__ void __launch_bounds__(THREADS)
qgemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ w_scale, const float* __restrict__ bias,
             float* __restrict__ out, int8_t* __restrict__ codes_out,
             float* __restrict__ scale_out, int M, int N, int K, int kc,
             int nsub) {
  using W = Warps<BM, BN>;
  extern __shared__ __align__(16) char smem[];
  const int kp = (K + 31) / 32 * 32;
  const int nchunks = (kp + kc - 1) / kc;
  const int mtiles = (M + BM - 1) / BM;
  const int ntiles = (N + BN - 1) / BN;
  // several row tiles a block: two x buffers; several column tiles (or K
  // in chunks): two weight buffers
  const int xbufs = nchunks > 1 || mtiles > (int)gridDim.x ? 2 : 1;
  const int wbufs = nchunks > 1 || nsub > 1 ? 2 : 1;
  const Layout L(BM, BN, kc, sizeof(T), xbufs, wbufs);
  char* xs = smem;                        // x chunks of L.x_bytes
  char* ws = smem + xbufs * L.x_bytes;    // weight chunks of L.w_bytes
  char* cs = ws + wbufs * L.w_bytes;
  float* s_scale = reinterpret_cast<float*>(cs + L.c_bytes);

  const bool first_n = blockIdx.y == 0;  // writes codes and scales
  int8_t* codes = first_n ? codes_out : nullptr;
  float* scales = first_n ? scale_out : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool mma_warp = warp < W::M * W::N;
  const int wm = warp % W::M, wn = warp / W::M;
  const bool small = kp <= (1 << 22) / (127 * 127);  // |acc| < 2^22
  int acc[W::MT][W::NT][4];

  if (nchunks == 1) {
    // Steps (row tile, column tile), row-major over this block's tiles;
    // each step's copies are issued one step ahead.
    const int nt0 = blockIdx.y * nsub;
    const int nsteps = min(nsub, ntiles - nt0);
    load_x<T, BM, MASKED>(xs, L.x_ld, x, M, K, blockIdx.x * BM, 0, kp);
    cp_async_commit();
    load_w<BN, MASKED>(ws, L.w_ld, wq, N, K, nt0 * BN, 0, kp);
    cp_async_commit();
    int xb = 0, wb = 0;
    for (int mt = blockIdx.x; mt < mtiles; mt += gridDim.x, xb ^= xbufs - 1) {
      const int m0 = mt * BM;
      for (int j = 0; j < nsteps; ++j, wb ^= nsteps > 1) {
        const bool first = mt == (int)blockIdx.x && j == 0;
        // this step's copies have landed (the first step: its x; its
        // weights land while the rows are quantized)
        if (first)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();     // and the last step is done with its buffers
        const bool last_n = j + 1 == nsteps;
        if (!last_n)
          load_w<BN, MASKED>(ws + (wb ^ 1) * L.w_bytes, L.w_ld, wq, N, K,
                             (nt0 + j + 1) * BN, 0, kp);
        else if (mt + gridDim.x < mtiles) {
          load_x<T, BM, MASKED>(xs + (xb ^ 1) * L.x_bytes, L.x_ld, x, M, K,
                                (mt + gridDim.x) * BM, 0, kp);
          if (nsteps > 1)
            load_w<BN, MASKED>(ws + (wb ^ 1) * L.w_bytes, L.w_ld, wq, N, K,
                               nt0 * BN, 0, kp);
        }
        cp_async_commit();
        if (j == 0) {
          quantize_chunk<T, BM, MASKED>(xs + xb * L.x_bytes, L.x_ld, cs, L.c_ld,
                                        s_scale, true, codes, scales, M, K, m0,
                                        0, kp);
          if (first) cp_async_wait<1>();  // all but the prefetch just issued
          __syncthreads();
        }
        if (mma_warp) {
#pragma unroll
          for (int a = 0; a < W::MT; ++a)
#pragma unroll
            for (int b = 0; b < W::NT; ++b)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;
          mma_chunk<BM, BN>(acc, cs, L.c_ld, ws + wb * L.w_bytes, L.w_ld, kp,
                            wm, wn, g, t);
          epilogue<BM, BN, MASKED>(acc, s_scale, w_scale, bias, out, M, N, m0,
                                   (nt0 + j) * BN, small, wm, wn, g, t);
        }
      }
    }
    return;
  }

  const int n0 = blockIdx.y * BN;  // K in chunks: one column tile a block
  for (int mt = blockIdx.x; mt < mtiles; mt += gridDim.x) {
    const int m0 = mt * BM;
    load_x<T, BM, MASKED>(xs, L.x_ld, x, M, K, m0, 0, kc);
    cp_async_commit();
    load_w<BN, MASKED>(ws, L.w_ld, wq, N, K, n0, 0, kc);
    cp_async_commit();
    // First sweep of the rows: abs-max over all of K, a warp per row.
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int m = m0 + r;
      float mx = 0.f;
      if (!MASKED || m < M) {
        const T* row = x + (size_t)m * K;
        for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(to_f32(row[k])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) {
        const float s = fmaxf(__fdiv_rn(mx, 127.f), 1e-8f);
        s_scale[r] = s;
        if (scales != nullptr && m < M) scales[m] = s;
      }
    }
#pragma unroll
    for (int a = 0; a < W::MT; ++a)
#pragma unroll
      for (int b = 0; b < W::NT; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;
    for (int c = 0; c < nchunks; ++c) {
      const int buf = c & 1;
      const int k0 = c * kc;
      const int kwp = min(kc, kp - k0);
      if (c + 1 < nchunks) {
        const int k1 = k0 + kc;
        load_x<T, BM, MASKED>(xs + (buf ^ 1) * L.x_bytes, L.x_ld, x, M, K, m0,
                              k1, min(kc, kp - k1));
      }
      cp_async_commit();
      if (c + 1 < nchunks) {
        const int k1 = k0 + kc;
        load_w<BN, MASKED>(ws + (buf ^ 1) * L.w_bytes, L.w_ld, wq, N, K, n0,
                           k1, min(kc, kp - k1));
      }
      cp_async_commit();
      cp_async_wait<3>();  // this chunk's x has landed
      __syncthreads();
      quantize_chunk<T, BM, MASKED>(xs + buf * L.x_bytes, L.x_ld, cs, L.c_ld,
                                    s_scale, false, codes, scales, M, K, m0, k0, kwp);
      cp_async_wait<2>();  // and its weights
      __syncthreads();
      if (mma_warp)
        mma_chunk<BM, BN>(acc, cs, L.c_ld, ws + buf * L.w_bytes, L.w_ld, kwp,
                          wm, wn, g, t);
      __syncthreads();  // buffers and codes are free for the next chunk
    }
    if (mma_warp)
      epilogue<BM, BN, MASKED>(acc, s_scale, w_scale, bias, out, M, N, m0, n0,
                               small, wm, wn, g, t);
    __syncthreads();  // s_scale is rewritten by the next row tile
  }
}

template <typename T, int BM, int BN, bool MASKED>
cudaError_t launch(const void* x, const void* wq, const void* w_scale,
                   const void* bias, void* out, void* codes_out,
                   void* scale_out, int M, int N, int K, int kc, int grid_m,
                   int nsub, int smem, cudaStream_t stream) {
  // Above 48 KB a kernel takes dynamic shared memory only once allowed;
  // allowed once per instantiation, up to the block maximum.
  static const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_kernel<T, BM, BN, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(grid_m, ((N + BN - 1) / BN + nsub - 1) / nsub);
  qgemm_kernel<T, BM, BN, MASKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<int8_t*>(codes_out),
      static_cast<float*>(scale_out), M, N, K, kc, nsub);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t dispatch(int bm, int bn, const void* x, const void* wq,
                     const void* w_scale, const void* bias, void* out,
                     void* codes_out, void* scale_out, int M, int N, int K,
                     int kc, int grid_m, int nsub, int smem, cudaStream_t s) {
#define EVAM_TILE(BM_, BN_)                                                     \
  if (bm == BM_ && bn == BN_)                                                   \
    return launch<T, BM_, BN_, MASKED>(x, wq, w_scale, bias, out, codes_out,    \
                                       scale_out, M, N, K, kc, grid_m, nsub, smem, s);
  EVAM_TILE(64, 64)
  EVAM_TILE(32, 64)
  EVAM_TILE(16, 64)
  EVAM_TILE(16, 32)
  EVAM_TILE(16, 8)
#undef EVAM_TILE
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a CUDA error code (0 on
// success). x: [M, K] bf16 (x_is_bf16 = 1) or f32; wq: [N, K] int8;
// w_scale: [N] f32; bias: [N] f32 or null; out: [M, N] f32. codes_out
// ([M, K] int8) and scale_out ([M] f32) are null, or receive the
// quantized rows. The launch plan (bm, bn, kc, grid_m, nsub, masked,
// smem) comes from ops/qgemm.py::plan; a plan this source cannot run (an
// unknown tile, too little shared memory, an aligned plan for a shape or
// pointer that breaks its preconditions) returns cudaErrorInvalidValue
// and launches nothing.
int evam_qgemm(const void* x, int x_is_bf16, const void* wq,
               const void* w_scale, const void* bias, void* out,
               void* codes_out, void* scale_out, int M, int N, int K,
               int bm, int bn, int kc, int grid_m, int nsub, int masked,
               int smem, void* stream) {
  const int esize = x_is_bf16 ? 2 : 4;
  const int kp = (K + 31) / 32 * 32;
  if (M <= 0 || N <= 0 || K <= 0 || kc <= 0 || kc % 32 != 0 || bm <= 0 ||
      bn <= 0 || grid_m <= 0 || grid_m > (M + bm - 1) / bm || nsub <= 0)
    return cudaErrorInvalidValue;
  const bool chunked = kc < kp, many = grid_m < (M + bm - 1) / bm;
  if (chunked && nsub != 1) return cudaErrorInvalidValue;
  const Layout L(bm, bn, kc, esize, chunked || many ? 2 : 1,
                 chunked || nsub > 1 ? 2 : 1);
  if (smem < L.total || smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (!masked && (M % bm != 0 || N % bn != 0 || K % 32 != 0 || !aligned16(x) ||
                  !aligned16(wq) || !aligned16(w_scale) || !aligned16(out) ||
                  (bias != nullptr && !aligned16(bias)) ||
                  (codes_out != nullptr && !aligned16(codes_out))))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (x_is_bf16) {
    rc = masked ? dispatch<__nv_bfloat16, true>(bm, bn, x, wq, w_scale, bias, out,
                                                codes_out, scale_out, M, N, K, kc,
                                                grid_m, nsub, smem, s)
                : dispatch<__nv_bfloat16, false>(bm, bn, x, wq, w_scale, bias, out,
                                                 codes_out, scale_out, M, N, K, kc,
                                                 grid_m, nsub, smem, s);
  } else {
    rc = masked ? dispatch<float, true>(bm, bn, x, wq, w_scale, bias, out, codes_out,
                                        scale_out, M, N, K, kc, grid_m, nsub, smem, s)
                : dispatch<float, false>(bm, bn, x, wq, w_scale, bias, out, codes_out,
                                         scale_out, M, N, K, kc, grid_m, nsub, smem, s);
  }
  return static_cast<int>(rc);
}

const char* evam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
