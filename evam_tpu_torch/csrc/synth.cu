// Device-synth wire batches: one uint32 seed per item -> its uint8 wire
// frame, made on the card.
//
// Ports the generator of evam_tpu/engine/steps.py::wrap_device_synth
// (with weyl_bits, :47): no Pallas kernel, XLA fused it into one pass
// over the batch. For seeds [B] and n = the bytes of one wire frame it
// writes out [B, n] with
//
//   mix_b      = seed_b * 0x9E3779B9                  (mod 2^32)
//   out[b, j]  = ((j * 2654435761 + mix_b) >> 13) & 0xFF  (mod 2^32)
//
// in 32-bit unsigned arithmetic, whose wraparound C++ defines, so it
// equals the plain version (evam_tpu_torch/ops/synth.py::
// synth_wire_reference, int64 with masks) byte for byte.
//
// What bounds it: it reads B seeds and writes B * n bytes (50 MB at the
// detect wire, 768 x 512, bucket 128), a pure store stream with a few
// integer operations a byte; the bound is the bytes over the HBM rate.
// The design does nothing but keep the stores wide and coalesced: each
// thread makes 16 consecutive bytes of the flat [B * n] output and
// stores them as one 16-byte uint4 (the allocator's 256-byte alignment
// keeps every such store aligned), neighbouring threads on neighbouring
// 16-byte chunks, grid-stride over the batch. A chunk may straddle two
// items where n is not a multiple of 16: its bytes then take the next
// item's seed from the byte where the row turns. The last chunk, where
// B * n is not a multiple of 16, stores byte by byte. No shared memory,
// no tensor cores, no TMA: nothing is reused.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// blocks at most: 132 SMs x 8 blocks of 256 threads (the SM's 2048)
constexpr long long MAX_BLOCKS = 132 * 8;
constexpr uint32_t WEYL = 2654435761u;
constexpr uint32_t MIX = 0x9E3779B9u;

__device__ __forceinline__ uint32_t synth_byte(uint32_t j, uint32_t mix) {
  return ((j * WEYL + mix) >> 13) & 0xFFu;
}

__global__ void __launch_bounds__(THREADS)
    synth_wire_kernel(const uint32_t* __restrict__ seeds, long long batch,
                      long long n, uint8_t* __restrict__ out) {
  const long long total = batch * n;
  const long long chunks = total / 16;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // every wire batch of the zoo has B * n < 2^32: a 32-bit division
  const bool narrow = total <= 0xFFFFFFFFll;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       c < chunks; c += stride) {
    const long long flat = c * 16;
    long long b;
    uint32_t j;
    if (narrow) {
      const uint32_t f = static_cast<uint32_t>(flat);
      const uint32_t nn = static_cast<uint32_t>(n);
      const uint32_t q = f / nn;
      b = q;
      j = f - q * nn;
    } else {
      b = flat / n;
      j = static_cast<uint32_t>(flat - b * n);
    }
    uint32_t v = j * WEYL + __ldg(seeds + b) * MIX;  // stepped by WEYL
    uint32_t words[4];
    if (static_cast<long long>(j) + 16 <= n) {  // the chunk is in one row
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          word |= ((v >> 13) & 0xFFu) << (8 * k);
          v += WEYL;
        }
        words[w] = word;
      }
    } else {  // the row turns inside the chunk (n not a multiple of 16)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          word |= ((v >> 13) & 0xFFu) << (8 * k);
          v += WEYL;
          if (++j == n) {
            j = 0;
            ++b;
            v = b < batch ? __ldg(seeds + b) * MIX : 0u;
          }
        }
        words[w] = word;
      }
    }
    reinterpret_cast<uint4*>(out)[c] =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
  // the masked tail: fewer than 16 bytes, one thread of the grid
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long flat = chunks * 16; flat < total; ++flat) {
      const long long b = flat / n;
      out[flat] = static_cast<uint8_t>(synth_byte(
          static_cast<uint32_t>(flat - b * n), __ldg(seeds + b) * MIX));
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a CUDA error code (0 on
// success). seeds: [batch] uint32 (an int32 view of the same bytes
// reads the same); out: [batch, n] uint8, 16-byte aligned. n must fit in
// 32 bits (a wire frame's bytes); anything else returns
// cudaErrorInvalidValue and launches nothing.
int evam_synth_wire(const void* seeds, long long batch, long long n, void* out,
                    void* stream) {
  if (batch <= 0 || n <= 0 || n > 0xFFFFFFFFll || seeds == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(seeds) % 4 != 0)
    return cudaErrorInvalidValue;
  const long long chunks = batch * n / 16;
  long long blocks = (chunks + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  if (blocks < 1) blocks = 1;  // the tail alone
  synth_wire_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(seeds), batch, n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* evam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
