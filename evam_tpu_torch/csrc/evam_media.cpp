// Native media kernels for the host-side frame path of evam_tpu_torch.
//
// A copy of the reference's native/evam_media.cpp: per-frame resize +
// BGR->I420 wire encoding feeding the batch engine
// (evam_tpu_torch/stages/infer.py), fused into one pass over the source
// image (bilinear sample -> YUV in registers -> planar store), the plain
// conversions, and the motion gate's luma grid. Parallelized with OpenMP
// and called through ctypes (evam_tpu_torch/native.py), which releases
// the interpreter lock for the length of each call, so the stream
// threads encode in parallel instead of serializing on numpy. The numpy
// copies of the same arithmetic (ops/color.py, media/luma.py)
// give the same bytes.
//
// Build: evam_tpu_torch/native.py compiles it on first use with
// g++ -O3 -fPIC -fopenmp -std=c++17 -shared into build/native/.

#include <cstdint>
#include <cstring>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// BT.601 full-range BGR -> YUV (the cv2 COLOR_BGR2YUV_I420 matrix,
// so the native and the numpy paths produce matching wire bytes).
static inline void bgr_to_yuv(int b, int g, int r,
                              int &y, int &u, int &v) {
    y = ( 66 * r + 129 * g +  25 * b + 128) >> 8;  y += 16;
    u = (-38 * r -  74 * g + 112 * b + 128) >> 8;  u += 128;
    v = (112 * r -  94 * g -  18 * b + 128) >> 8;  v += 128;
    y = std::min(255, std::max(0, y));
    u = std::min(255, std::max(0, u));
    v = std::min(255, std::max(0, v));
}

// Bilinear-resize src (sh x sw x 3, BGR, uint8) to (dh x dw) and
// write I420 planes into dst (dh*3/2 rows of dw bytes).
// dh must be %4==0 and dw %2==0 (wire contract, ops/color.py).
// Fixed-point (8-bit fractional weights) with precomputed horizontal
// coordinate/weight tables: the inner loop is integer MACs the
// compiler can vectorize; rows parallelize over OpenMP on many-core
// hosts.
void resize_bgr_to_i420(const uint8_t *src, int sh, int sw,
                        uint8_t *dst, int dh, int dw) {
    uint8_t *yp = dst;
    uint8_t *up = dst + (size_t)dh * dw;
    uint8_t *vp = up + (size_t)(dh / 2) * (dw / 2);
    const int32_t sx_fp = (int32_t)(((int64_t)sw << 16) / dw);
    const int32_t sy_fp = (int32_t)(((int64_t)sh << 16) / dh);

    // Horizontal tables: source offsets (in bytes) and 0..256 weights.
    int32_t *x0o = new int32_t[dw * 2];
    int32_t *x1o = x0o + dw;
    int16_t *wx1 = new int16_t[dw];
    for (int ox = 0; ox < dw; ++ox) {
        int64_t fx = ((int64_t)ox * sx_fp + (sx_fp >> 1)) - (1 << 15);
        if (fx < 0) fx = 0;
        int x0 = (int)(fx >> 16);
        int x1 = std::min(x0 + 1, sw - 1);
        x0o[ox] = x0 * 3;
        x1o[ox] = x1 * 3;
        wx1[ox] = (int16_t)((fx >> 8) & 0xFF);
    }

#pragma omp parallel for schedule(static)
    for (int oy2 = 0; oy2 < dh / 2; ++oy2) {
        for (int k = 0; k < 2; ++k) {
            int oy = oy2 * 2 + k;
            int64_t fy = ((int64_t)oy * sy_fp + (sy_fp >> 1)) - (1 << 15);
            if (fy < 0) fy = 0;
            int y0 = (int)(fy >> 16);
            int y1 = std::min(y0 + 1, sh - 1);
            int wy = (int)((fy >> 8) & 0xFF);
            const uint8_t *row0 = src + (size_t)y0 * sw * 3;
            const uint8_t *row1 = src + (size_t)y1 * sw * 3;
            uint8_t *yrow = yp + (size_t)oy * dw;
            uint8_t *urow = up + (size_t)oy2 * (dw / 2);
            uint8_t *vrow = vp + (size_t)oy2 * (dw / 2);
            for (int ox = 0; ox < dw; ++ox) {
                const uint8_t *p00 = row0 + x0o[ox];
                const uint8_t *p01 = row0 + x1o[ox];
                const uint8_t *p10 = row1 + x0o[ox];
                const uint8_t *p11 = row1 + x1o[ox];
                int wx = wx1[ox];
                int b0 = p00[0] + (((p01[0] - p00[0]) * wx) >> 8);
                int g0 = p00[1] + (((p01[1] - p00[1]) * wx) >> 8);
                int r0 = p00[2] + (((p01[2] - p00[2]) * wx) >> 8);
                int b1 = p10[0] + (((p11[0] - p10[0]) * wx) >> 8);
                int g1 = p10[1] + (((p11[1] - p10[1]) * wx) >> 8);
                int r1 = p10[2] + (((p11[2] - p10[2]) * wx) >> 8);
                int b = b0 + (((b1 - b0) * wy) >> 8);
                int g = g0 + (((g1 - g0) * wy) >> 8);
                int r = r0 + (((r1 - r0) * wy) >> 8);
                int yv = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16;
                yrow[ox] = (uint8_t)std::min(255, std::max(0, yv));
                if ((k | (ox & 1)) == 0) {
                    int uv = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128;
                    int vv = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128;
                    urow[ox >> 1] = (uint8_t)std::min(255, std::max(0, uv));
                    vrow[ox >> 1] = (uint8_t)std::min(255, std::max(0, vv));
                }
            }
        }
    }
    delete[] x0o;
    delete[] wx1;
}

// Plain BGR -> I420 (no resize), same plane layout.
void bgr_to_i420(const uint8_t *src, uint8_t *dst, int h, int w) {
    uint8_t *yp = dst;
    uint8_t *up = dst + (size_t)h * w;
    uint8_t *vp = up + (size_t)(h / 2) * (w / 2);
#pragma omp parallel for schedule(static)
    for (int y = 0; y < h; ++y) {
        const uint8_t *row = src + (size_t)y * w * 3;
        for (int x = 0; x < w; ++x) {
            int yv, uv, vv;
            bgr_to_yuv(row[x * 3], row[x * 3 + 1], row[x * 3 + 2],
                       yv, uv, vv);
            yp[(size_t)y * w + x] = (uint8_t)yv;
            if ((y & 1) == 0 && (x & 1) == 0) {
                up[(size_t)(y / 2) * (w / 2) + x / 2] = (uint8_t)uv;
                vp[(size_t)(y / 2) * (w / 2) + x / 2] = (uint8_t)vv;
            }
        }
    }
}

// Bilinear BGR resize (uint8, 3ch).
void resize_bgr(const uint8_t *src, int sh, int sw,
                uint8_t *dst, int dh, int dw) {
    const float sx = (float)sw / dw;
    const float sy = (float)sh / dh;
#pragma omp parallel for schedule(static)
    for (int oy = 0; oy < dh; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        int y0 = (int)fy; if (fy < 0) y0 = 0;
        int y1 = std::min(y0 + 1, sh - 1);
        float wy = fy - y0; if (wy < 0) wy = 0;
        const uint8_t *row0 = src + (size_t)y0 * sw * 3;
        const uint8_t *row1 = src + (size_t)y1 * sw * 3;
        uint8_t *out = dst + (size_t)oy * dw * 3;
        for (int ox = 0; ox < dw; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            int x0 = (int)fx; if (fx < 0) x0 = 0;
            int x1 = std::min(x0 + 1, sw - 1);
            float wx = fx - x0; if (wx < 0) wx = 0;
            float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
            float w10 = wy * (1 - wx),       w11 = wy * wx;
            for (int ch = 0; ch < 3; ++ch) {
                out[ox * 3 + ch] = (uint8_t)(
                      w00 * row0[x0 * 3 + ch] + w01 * row0[x1 * 3 + ch]
                    + w10 * row1[x0 * 3 + ch] + w11 * row1[x1 * 3 + ch]
                    + 0.5f);
            }
        }
    }
}

// Downsampled luma grid for the motion gate (stages/gate.py):
// one gh x gw uint8 grid summarizing the frame's BT.601 luma, sampled
// on a fixed (gh*S) x (gw*S) point lattice instead of a full pass —
// per-frame cost is O(gh*gw*S^2) regardless of resolution, cheap
// enough for the decode/stream thread at 64-stream fan-in. Integer
// math only, and the numpy copy (media/luma.py) replays the
// exact same lattice + arithmetic, so gate decisions are identical
// with or without the shared library.
void luma_grid(const uint8_t *src, int h, int w,
               uint8_t *dst, int gh, int gw) {
    const int S = 4;                       // sample points per cell edge
    const int N = gh * S, M = gw * S;
#pragma omp parallel for schedule(static)
    for (int gy = 0; gy < gh; ++gy) {
        for (int gx = 0; gx < gw; ++gx) {
            int acc = 0;
            for (int j = 0; j < S; ++j) {
                int i = gy * S + j;
                int y = (int)(((2LL * i + 1) * h) / (2 * N));
                const uint8_t *row = src + (size_t)y * w * 3;
                for (int k = 0; k < S; ++k) {
                    int jj = gx * S + k;
                    int x = (int)(((2LL * jj + 1) * w) / (2 * M));
                    const uint8_t *p = row + (size_t)x * 3;
                    // BT.601 luma, same matrix as bgr_to_yuv above
                    int yv = ((66 * p[2] + 129 * p[1] + 25 * p[0] + 128)
                              >> 8) + 16;
                    acc += yv < 0 ? 0 : (yv > 255 ? 255 : yv);
                }
            }
            dst[(size_t)gy * gw + gx] = (uint8_t)(acc / (S * S));
        }
    }
}

int evam_native_version() { return 2; }

}  // extern "C"
