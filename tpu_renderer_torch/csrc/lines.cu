// K6 lines: the wireframe mask against the final z-buffer.
//
// Replaces tpu_renderer/ops/raster_pallas.py lines_pallas (:2561, kernel
// body :2600-2642; tables from pack_lines :2507).
//
// A pixel is lit iff some active edge's right-to-left DDA pixel lands on it
// inside the edge's bbox and inside 0 < row < h-1, 0 < col < w-1, and the
// strict ``zbuf - z > 0`` test passes (no handedness sign: the reference
// shader hard-codes ``> 0``). The DDA is inverted in closed form: along the
// major axis the step is exactly -1 in x or +-1 in y, so the step index is
// k = floor(x0 - col), or ceil(row - y0) / floor(y0 - row) in y, and the
// pixel lies on the line iff floor of the minor coordinate at step k is its
// own and 0 <= k < nsteps. Every edge writes the same colour, so the mask is
// an OR that does not depend on visit order: no atomics.
//
// What bounds it on the H100: the per-(pixel, edge) test over each tile's
// edge list (bbox-binned by raster_cuda.tile_bins, ~25 flops a visit); the
// bytes are only the z-buffer in and the mask out (8.4 MB at 1024^2).
// Design: one thread per pixel, one 16x16 block per tile; pixels outside the
// frame interior skip the edge loop, and a thread stops at its first lit
// edge. -fmad=false keeps it bit-identical to the
// plain version (raster_cuda.lines_plain).
#include "common.cuh"

namespace {

constexpr int L_COLS = 8;    // x0 y0 z0 sx sy sz nsteps majx (pack_lines)

__global__ void lines_kernel(const float* __restrict__ ldata,
                             const int* __restrict__ lbbox,
                             const int* __restrict__ tile_off,
                             const int* __restrict__ tile_items,
                             const float* __restrict__ zbuf, int height,
                             int width, int tiles_x, int* __restrict__ mask) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const size_t p = (size_t)row * width + col;
    const float r = static_cast<float>(row);
    const float c = static_cast<float>(col);
    int lit = 0;
    if (r > 0.0f && r < static_cast<float>(height) - 1.0f && c > 0.0f &&
        c < static_cast<float>(width) - 1.0f) {
        const float zb = zbuf[p];
        const int tile = blockIdx.y * tiles_x + blockIdx.x;
        for (int k = tile_off[tile]; k < tile_off[tile + 1]; ++k) {
            const int e = tile_items[k];
            const int* bb = lbbox + (size_t)e * 4;
            if (!(col >= bb[0] && col < bb[1] && row >= bb[2] && row < bb[3]))
                continue;
            const float* d = ldata + (size_t)e * L_COLS;
            const float x0 = d[0], y0 = d[1], z0 = d[2];
            const float sx = d[3], sy = d[4], sz = d[5];
            const bool majx = d[7] > 0.0f;
            const float kk = majx ? floorf(x0 - c)
                                  : (sy > 0.0f ? ceilf(r - y0) : floorf(y0 - r));
            const float other = majx ? floorf(y0 + kk * sy) - r
                                     : floorf(x0 + kk * sx) - c;
            if (other == 0.0f && kk >= 0.0f && kk < d[6]) {
                const float z = z0 + kk * sz;
                if (zb - z > 0.0f) {
                    lit = 1;
                    break;
                }
            }
        }
    }
    mask[p] = lit;
}

}  // namespace

TR_EXPORT int tr_lines(const float* ldata, const int* lbbox,
                       const int* tile_off, const int* tile_items,
                       const float* zbuf, int height, int width, int tiles_x,
                       int* mask, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    lines_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        ldata, lbbox, tile_off, tile_items, zbuf, height, width, tiles_x,
        mask);
    return (int)cudaGetLastError();
}
