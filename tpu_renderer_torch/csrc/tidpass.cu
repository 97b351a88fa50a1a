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
// The claim is K1's one walk (visibility.cu) with two changes: the running
// minimum m starts at the given zb_sign[p] instead of +inf, and is never
// lowered (face_walk.cuh WALK_CLAIM). Each covering face in face order then
// sets cand = face where zs = z*sign passes zs <= zb, so cand ends as the
// LAST such face. zs <= zb and zb >= zs are the same IEEE comparison: both
// false when either side is NaN, both true on ties (later face wins), so
// this is exactly the reference's claim (pass 3, triangular.py:99-109).
//
// What bounds it on the H100: as K1, latency: the binning (csrc/bins.cu),
// the chunk loop's loads and the walk over the tile's staged faces, not
// bytes (1.4 us of needed bytes at 1024^2). Before this design K7 walked a
// tile list built in torch with a host sync (tile_bins' nonzero) backwards,
// one chain of dependent global loads per (pixel, face) visit. Design: the
// lists come from csrc/bins.cu over the rows from row0 (no host sync), and
// the block refines, compacts, stages and walks them as K1 does
// (face_walk.cuh). Pixel math runs in global coordinates (row0 + local
// row). Op-by-op rounding (-fmad=false) keeps it bit-identical to the plain
// version (raster_cuda.tidpass_plain).
//
// With a debug camera (fdbg not null; tidpass_pallas with_debug=True) the
// claim tests the debug camera's clip space too, in the DEBUG walk
// (face_walk.cuh), as K1 does.
#include "face_walk.cuh"

namespace {

template <bool DEBUG>
__global__ void __launch_bounds__(BLOCK)
    tidpass_kernel(const float* __restrict__ fdata,
                   const int* __restrict__ flags,
                   const float* __restrict__ fdbg,
                   const int* __restrict__ bin_counts,
                   const int* __restrict__ bin_items, int n_faces,
                   const float* __restrict__ zb_sign, int height, int width,
                   int row0, int gid0, float sign, int* __restrict__ tid_out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    const bool in_frame = row < height && col < width;
    const size_t p = (size_t)row * width + col;
    const int ct = coarse_tile_of_block(width);
    // A thread outside the frame walks with the block and writes nothing.
    float m = in_frame ? zb_sign[p] : -INFINITY;
    int cand = -1;
    walk_faces<WALK_CLAIM, DEBUG>(
        fdata, flags, fdbg, bin_items + (size_t)ct * n_faces, bin_counts[ct],
        blockIdx.x * TILE, row0 + blockIdx.y * TILE,
        static_cast<float>(row0 + row), static_cast<float>(col), sign, m,
        cand);
    if (in_frame) tid_out[p] = cand < 0 ? -1 : gid0 + cand;
}

}  // namespace

// fdbg: the (n_faces, DBG_COLS) debug planes, or null without a debug
// camera.
TR_EXPORT int tr_tidpass(const float* fdata, const int* flags,
                         const float* fdbg, int n_faces, int* bin_counts,
                         int* bin_items, const float* zb_sign, int height,
                         int width, int row0, int gid0, float sign, int* tid,
                         void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int rc =
        launch_coarse_bins(BIN_FACES, fdata, flags, n_faces, nullptr, height,
                           width, row0, bin_counts, bin_items, st);
    if (rc != 0) return rc;
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    if (fdbg) {
        // Once per process.
        static const cudaError_t opt_in =
            allow_debug_smem(tidpass_kernel<true>);
        if (opt_in != cudaSuccess) return (int)opt_in;
        tidpass_kernel<true><<<grid, block, DEBUG_SMEM, st>>>(
            fdata, flags, fdbg, bin_counts, bin_items, n_faces, zb_sign,
            height, width, row0, gid0, sign, tid);
    } else {
        tidpass_kernel<false><<<grid, block, 0, st>>>(
            fdata, flags, fdbg, bin_counts, bin_items, n_faces, zb_sign,
            height, width, row0, gid0, sign, tid);
    }
    return (int)cudaGetLastError();
}
