// K1 visibility: final z-buffer and winning face id per pixel, or the
// z-buffer alone.
//
// Replaces tpu_renderer/ops/raster_pallas.py visibility_gbuffer_pallas,
// phase 0 (the incremental z + id claim of each screen tile over its binned
// faces, raster_pallas.py:1591-1617), and visibility_pallas (:602), which
// computes the same and, with want_tid=False, the z-buffer alone.
//
// Semantics: the reference's two passes (triangular.py:96-118). Pass 1 keeps
// the minimum sign-space depth z*sign over covering z-writing faces; pass 2
// gives the pixel to the LAST face, in face order, that covers it and passes
// zb >= z*sign against the final buffer. No atomicMin z-buffer: that would
// lose the later-face-wins order on ties. The z-only mode (WANT_TID false)
// runs pass 1 alone: a triangle shard's local winners mean nothing before
// the shards' z-buffers are merged, and K7 (tidpass.cu) claims against the
// merged one.
//
// Sharding: the block grid covers a block of frame rows starting at row0,
// and the pixel math runs in global coordinates (row0 + local row, exact as
// a float below 2^24), so a shard's rows are bit-identical to the same rows
// of a one-device frame. The id written is the face's index in the table
// (K7 writes a shard's global ids).
//
// What bounds it on the H100: per-(pixel, face) arithmetic and the face-list
// walk — each visit reads a 34-float face row (the same row for the whole
// block, served from L1) and does ~10 flops, ~40 with the clip test. Design:
// one thread per pixel, one 16x16 block per tile; the face lists per tile
// are built in torch (raster_cuda.tile_bins, face order kept), so a thread
// visits only faces whose bbox touches its tile. Pass 2 walks the list
// backwards and stops at the first claimer, which is the last in face order.
// Arithmetic rounds op by op (-fmad=false), bit-identical to the plain
// version (raster_plain.py).
#include "common.cuh"

namespace {

template <bool WANT_TID>
__global__ void visibility_kernel(const float* __restrict__ fdata,
                                  const int* __restrict__ flags,
                                  const int* __restrict__ tile_off,
                                  const int* __restrict__ tile_items,
                                  int height, int width, int tiles_x,
                                  int row0, float sign,
                                  float* __restrict__ zb_out,
                                  int* __restrict__ tid_out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const float r = static_cast<float>(row0 + row);
    const float c = static_cast<float>(col);
    const int tile = blockIdx.y * tiles_x + blockIdx.x;
    const int k0 = tile_off[tile];
    const int k1 = tile_off[tile + 1];

    float zb = INFINITY;
    for (int k = k0; k < k1; ++k) {
        const int face = tile_items[k];
        const int fl = flags[face];
        if (!(fl & FLAG_ZWRITE)) continue;
        float z;
        if (face_cover(fdata + (size_t)face * F_COLS, fl, r, c, &z)) {
            const float zs = z * sign;
            if (zb >= zs) zb = zs;
        }
    }
    const size_t p = (size_t)row * width + col;
    zb_out[p] = zb;
    if constexpr (WANT_TID)
        tid_out[p] =
            claim_last(fdata, flags, tile_items, k0, k1, r, c, zb, sign);
}

}  // namespace

TR_EXPORT int tr_visibility(const float* fdata, const int* flags,
                            const int* tile_off, const int* tile_items,
                            int height, int width, int tiles_x, int row0,
                            float sign, int want_tid,
                            float* zb_sign, int* tid, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    cudaStream_t st = (cudaStream_t)stream;
    if (want_tid)
        visibility_kernel<true><<<grid, block, 0, st>>>(
            fdata, flags, tile_off, tile_items, height, width, tiles_x, row0,
            sign, zb_sign, tid);
    else
        visibility_kernel<false><<<grid, block, 0, st>>>(
            fdata, flags, tile_off, tile_items, height, width, tiles_x, row0,
            sign, zb_sign, tid);
    return (int)cudaGetLastError();
}
