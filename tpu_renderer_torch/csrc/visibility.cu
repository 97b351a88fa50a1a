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
// One walk instead of two. Each thread keeps a running minimum m (start
// +inf) and a candidate c (start -1); for each covering face in face order,
// with zs = z*sign:
//     if (zs <= m) { c = face; if (face writes z) m = zs; }
// m is pass 1's recurrence, so it ends as the final buffer Z. c ends as the
// LAST face with zs <= Z, pass 2's answer:
// - Z is never above the running m, so every face with zs <= Z passes
//   zs <= m when the walk reaches it; in particular the last one, L, does.
// - A face f that passes zs <= m but has zs > Z: then Z < +inf is some
//   z-writing face g's zs (a minimum of finitely many values), and g comes
//   after f (had it come before, m <= Z < zs at f). g passes zs <= m
//   (nothing is below Z) and zs <= Z, so a face passing both comes after
//   f, and the walk's last passer is never such an f: it is L.
// - NaN zs fails both tests (and never lowers m), as it fails both passes;
//   ties stay "later face wins" because the test is <=.
//
// Sharding: the block grid covers a block of frame rows starting at row0,
// and the pixel math runs in global coordinates (row0 + local row, exact as
// a float below 2^24), so a shard's rows are bit-identical to the same rows
// of a one-device frame. The id written is the face's index in the table
// (K7 writes a shard's global ids).
//
// What bounds it on the H100: neither bytes (2.7 us of needed bytes at
// 1024^2) nor the card's arithmetic rate, but latency, in three parts: the
// binning (csrc/bins.cu, a few dependent steps per chunk of the table), the
// chunk loop (list entry, flag word and bbox per candidate, then the rows'
// copy, each a round trip to L2), and the walk, which dominates: every
// thread of a block tests every face staged for its tile in turn, so the
// tiles with the longest lists set the kernel's time. Before this design
// every (pixel, face) visit was itself a chain of dependent global loads,
// the list was built in torch with a host sync, and claims walked it twice.
// Design: the lists come from csrc/bins.cu (coarse tiles, on the card, no
// host sync), and the block walks them as face_walk.cuh describes: refined
// to its 16x16 tile, ballot-compacted in face order, staged in shared
// memory by cp.async, then walked forward once (K7 shares that walk).
// Tensor cores do not apply: the per-(pixel, face) work is f32 compares and
// sums that must round op by op (-fmad=false) to stay bit-identical to the
// plain version (raster_plain.py), with no matrix product for wgmma.
//
// With a debug camera (fdbg not null; with_debug=True of both TPU kernels)
// each face also carries the debug camera's 18 planes, and a face that
// needs the per-pixel clip test must pass that second clip space too: the
// DEBUG instantiations stage those planes in dynamic shared memory beside
// the rows (face_walk.cuh). The walk and its claim are unchanged.
#include "face_walk.cuh"

namespace {

template <bool WANT_TID, bool DEBUG>
__global__ void __launch_bounds__(BLOCK)
    visibility_kernel(const float* __restrict__ fdata,
                      const int* __restrict__ flags,
                      const float* __restrict__ fdbg,
                      const int* __restrict__ bin_counts,
                      const int* __restrict__ bin_items, int n_faces,
                      int height, int width, int row0, float sign,
                      float* __restrict__ zb_out, int* __restrict__ tid_out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    const int ct = coarse_tile_of_block(width);
    float m = INFINITY;
    int cand = -1;
    walk_faces<WANT_TID ? WALK_Z_TID : WALK_Z, DEBUG>(
        fdata, flags, fdbg, bin_items + (size_t)ct * n_faces, bin_counts[ct],
        blockIdx.x * TILE, row0 + blockIdx.y * TILE,
        static_cast<float>(row0 + row), static_cast<float>(col), sign, m,
        cand);
    if (row < height && col < width) {
        const size_t p = (size_t)row * width + col;
        zb_out[p] = m;
        if constexpr (WANT_TID) tid_out[p] = cand;
    }
}

template <bool WANT_TID, bool DEBUG>
int launch_visibility(dim3 grid, cudaStream_t st, const float* fdata,
                      const int* flags, const float* fdbg,
                      const int* bin_counts, const int* bin_items, int n_faces,
                      int height, int width, int row0, float sign,
                      float* zb_sign, int* tid) {
    int smem = 0;
    if constexpr (DEBUG) {
        // Once per process for this instantiation.
        static const cudaError_t opt_in =
            allow_debug_smem(visibility_kernel<WANT_TID, DEBUG>);
        if (opt_in != cudaSuccess) return (int)opt_in;
        smem = DEBUG_SMEM;
    }
    visibility_kernel<WANT_TID, DEBUG><<<grid, dim3(TILE, TILE), smem, st>>>(
        fdata, flags, fdbg, bin_counts, bin_items, n_faces, height, width,
        row0, sign, zb_sign, tid);
    return (int)cudaGetLastError();
}

}  // namespace

// fdbg: the (n_faces, DBG_COLS) debug planes, or null without a debug
// camera.
TR_EXPORT int tr_visibility(const float* fdata, const int* flags,
                            const float* fdbg, int n_faces, int* bin_counts,
                            int* bin_items, int height, int width, int row0,
                            float sign, int want_tid, float* zb_sign, int* tid,
                            void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int rc =
        launch_coarse_bins(BIN_FACES, fdata, flags, n_faces, nullptr, height,
                           width, row0, bin_counts, bin_items, st);
    if (rc != 0) return rc;
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    auto* launch = want_tid ? (fdbg ? &launch_visibility<true, true>
                                    : &launch_visibility<true, false>)
                            : (fdbg ? &launch_visibility<false, true>
                                    : &launch_visibility<false, false>);
    return launch(grid, st, fdata, flags, fdbg, bin_counts, bin_items,
                  n_faces, height, width, row0, sign, zb_sign, tid);
}
