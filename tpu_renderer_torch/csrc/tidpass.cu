// K7 tidpass: winning face ids against a GIVEN final z-buffer.
//
// Replaces tpu_renderer/ops/raster_pallas.py tidpass_pallas (:2676,
// pallas_call :2762). Triangle-sharded rendering merges the shards'
// z-buffers with a MIN first; a shard's own winners are then stale (another
// shard's closer face may beat them, and a face that writes no z may claim
// at a depth its shard's buffer never reached), so every shard claims again
// against the merged buffer: the last local face, in face order, that
// covers the pixel and passes zb >= z*sign writes gid0 + its local index,
// -1 where none does. The MAX over shards of these shard-major ids is then
// the last-face-wins claim over all faces.
//
// What bounds it on the H100: per-(pixel, face) arithmetic over the face
// list, as K1's claim pass, which it is alone: one thread per pixel, one
// 16x16 block per tile of rows starting at row0 (pixel math in global
// coordinates), the tile's list (raster_cuda.tile_bins) walked backwards to
// the first claimer (common.cuh claim_last). Op-by-op rounding
// (-fmad=false) keeps it bit-identical to the plain version
// (raster_cuda.tidpass_plain).
#include "common.cuh"

namespace {

__global__ void tidpass_kernel(const float* __restrict__ fdata,
                               const int* __restrict__ flags,
                               const int* __restrict__ tile_off,
                               const int* __restrict__ tile_items,
                               const float* __restrict__ zb_sign,
                               int height, int width, int tiles_x, int row0,
                               int gid0, float sign,
                               int* __restrict__ tid_out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const float r = static_cast<float>(row0 + row);
    const float c = static_cast<float>(col);
    const int tile = blockIdx.y * tiles_x + blockIdx.x;
    const size_t p = (size_t)row * width + col;
    const int face = claim_last(fdata, flags, tile_items, tile_off[tile],
                                tile_off[tile + 1], r, c, zb_sign[p], sign);
    tid_out[p] = face < 0 ? -1 : gid0 + face;
}

}  // namespace

TR_EXPORT int tr_tidpass(const float* fdata, const int* flags,
                         const int* tile_off, const int* tile_items,
                         const float* zb_sign, int height, int width,
                         int tiles_x, int row0, int gid0, float sign,
                         int* tid, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    tidpass_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        fdata, flags, tile_off, tile_items, zb_sign, height, width, tiles_x,
        row0, gid0, sign, tid);
    return (int)cudaGetLastError();
}
