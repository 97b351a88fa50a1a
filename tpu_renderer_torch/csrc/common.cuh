// Shared definitions of the port's CUDA kernels.
//
// Layouts mirror tpu_renderer_torch/ops/raster_plain.py (F_*) and
// ops/raster_cuda.py (A_COLS, Q_COLS, QI_COLS). The library is compiled with
// -fmad=false: every product and sum below rounds on its own, as the plain
// PyTorch versions' elementwise ops do, so kernel and plain version agree
// bit for bit. Expressions are written in the plain versions' evaluation
// order, e.g. a*x + b*y + c means ((a*x) + (b*y)) + c.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TR_EXPORT extern "C" __attribute__((visibility("default")))

// Pixel tile edge: one block of TILE x TILE threads per binning tile
// (raster_cuda.TILE).
constexpr int TILE = 16;

// Packed face table (raster_cuda.pack_faces).
constexpr int F_AFF = 0;     // av bv cv aw bw cw az bz cz
constexpr int F_INV_W = 9;   // 1/w per vertex
constexpr int F_BBOX = 12;   // x0 x1 y0 y1 as float
constexpr int F_CLIP = 16;   // e[i][j] at 16 + 6*i + j
constexpr int F_COLS = 34;

constexpr int FLAG_VALID = 1;
constexpr int FLAG_ZWRITE = 4;
constexpr int FLAG_PPC = 8;

constexpr int A_COLS = 42;   // per-face shading attributes (pack_face_attrs)
constexpr int GB_CHANNELS = 32;
constexpr int Q_COLS = 44;   // quad table (pack_quads)
constexpr int QI_COLS = 8;

// Coverage and depth of one face at pixel (r, c): the barycentric inside
// test u, v, w >= 0 from the affine coefficients, the integer bbox window,
// validity, and — for faces flagged FLAG_PPC — the linearized per-pixel clip
// test (q_j > 0) == (S > 0), S != 0 (raster_pallas._face_tile_cov).
__device__ __forceinline__ bool face_cover(const float* __restrict__ f,
                                           int flags, float r, float c,
                                           float* z) {
    if (!(flags & FLAG_VALID)) return false;
    if (!(c >= f[F_BBOX] && c < f[F_BBOX + 1] && r >= f[F_BBOX + 2] &&
          r < f[F_BBOX + 3]))
        return false;
    const float v = f[0] * c + f[1] * r + f[2];
    const float w = f[3] * c + f[4] * r + f[5];
    const float u = 1.0f - v - w;
    if (!(u >= 0.0f && v >= 0.0f && w >= 0.0f)) return false;
    if (flags & FLAG_PPC) {
        const float s = u * f[F_INV_W] + v * f[F_INV_W + 1] + w * f[F_INV_W + 2];
        if (!(s != 0.0f)) return false;
        const bool s_pos = s > 0.0f;
        for (int j = 0; j < 6; ++j) {
            const float q = u * f[F_CLIP + j] + v * f[F_CLIP + 6 + j] +
                            w * f[F_CLIP + 12 + j];
            if ((q > 0.0f) != s_pos) return false;
        }
    }
    *z = f[6] * c + f[7] * r + f[8];
    return true;
}

// The claim against a final z-buffer value zb (sign space): the LAST face of
// the tile's list items[k0:k1] (face order) that covers pixel (r, c) and
// passes zb >= z*sign, or -1 (reference pass 3, triangular.py:99-109). The
// list is walked backwards and the walk stops at the first claimer. K1's
// claim pass and K7 share it.
__device__ __forceinline__ int claim_last(const float* __restrict__ fdata,
                                          const int* __restrict__ flags,
                                          const int* __restrict__ items,
                                          int k0, int k1, float r, float c,
                                          float zb, float sign) {
    for (int k = k1 - 1; k >= k0; --k) {
        const int face = items[k];
        float z;
        if (face_cover(fdata + (size_t)face * F_COLS, flags[face], r, c, &z) &&
            zb >= z * sign)
            return face;
    }
    return -1;
}
