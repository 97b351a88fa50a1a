// K4 stencil: signed shadow-volume stencil against the final z-buffer.
//
// Replaces tpu_renderer/ops/raster_pallas.py stencil_pallas (:964, kernel
// body :1064-1128).
//
// For each geometry pixel (zb < 3e38) and each clipped shadow polygon with
// ok set: inside iff every active edge half-plane A*x + B*y + K is > 0
// (shadow.quad_edge_coeffs, orientation folded in), and the plane depth
// passes the multiply-compare test of raster_pallas.py:1100-1103,
// ((zb*q - sign*nf2 >= 0) == (q > 0)) with q = (far+near) - zraw*(far-near);
// then +1 for a front polygon, -1 for a back one. The integer sum is exact,
// so any visit order gives the same stencil.
//
// What bounds it on the H100: per-(pixel, quad) arithmetic — up to 12 edge
// evaluations and the depth test — over the quads whose bbox touches the
// pixel's tile; shadow quads are long slivers, so those lists are long.
// Design: one thread per pixel, one 16x16 block per tile, per-tile quad
// lists from torch (raster_cuda.tile_bins over the ok quads); a thread
// leaves the edge loop at the first edge that fails and skips background
// pixels outright. Op-by-op rounding (-fmad=false) keeps it bit-identical
// to the plain version (shadow.quad_fragments). The rows start at row0 (a
// block of frame rows, pixel math in global coordinates), and so do the
// quads' tile lists.
#include "common.cuh"

namespace {

__global__ void stencil_kernel(const float* __restrict__ qdata,
                               const int* __restrict__ qi,
                               const int* __restrict__ tile_off,
                               const int* __restrict__ tile_items,
                               const float* __restrict__ zb_sign, int height,
                               int width, int tiles_x, int row0,
                               float sign_nf2,
                               float fpn, float fmn, int* __restrict__ out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const size_t p = (size_t)row * width + col;
    const float zb = zb_sign[p];
    int acc = 0;
    if (zb < 3e38f) {
        const float r = static_cast<float>(row0 + row);
        const float c = static_cast<float>(col);
        const int tile = blockIdx.y * tiles_x + blockIdx.x;
        for (int k = tile_off[tile]; k < tile_off[tile + 1]; ++k) {
            const int q = tile_items[k];
            const int* qq = qi + (size_t)q * QI_COLS;
            if (qq[5] <= 0) continue;
            const float* d = qdata + (size_t)q * Q_COLS;
            const int n = min(max(qq[4], 0), 12);
            bool inside = true;
            for (int i = 0; i < n; ++i) {
                const float e = d[i] * c + d[12 + i] * r + d[24 + i];
                if (!(e > 0.0f)) {
                    inside = false;
                    break;
                }
            }
            if (!inside) continue;
            const float zraw = d[36] * c + d[37] * r + d[38];
            const float qden = fpn - zraw * fmn;
            if ((zb * qden - sign_nf2 >= 0.0f) == (qden > 0.0f))
                acc += (qq[6] > 0) ? 1 : -1;
        }
    }
    out[p] = acc;
}

}  // namespace

TR_EXPORT int tr_stencil(const float* qdata, const int* qi,
                         const int* tile_off, const int* tile_items,
                         const float* zb_sign, int height,
                         int width, int tiles_x, int row0, float sign_nf2,
                         float fpn, float fmn, int* stencil, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    stencil_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        qdata, qi, tile_off, tile_items, zb_sign, height, width, tiles_x,
        row0, sign_nf2, fpn, fmn, stencil);
    return (int)cudaGetLastError();
}
