// The staged forward walk of one 16x16 tile's faces, shared by K1
// (visibility.cu, both modes) and K7 (tidpass.cu).
//
// One 16x16 block per tile, one thread per pixel. The block walks its
// coarse tile's list (csrc/bins.cu: valid faces whose bbox overlaps the
// COARSE x COARSE tile, in face order) in chunks of BLOCK faces:
// - refine: each thread tests one face's bbox against the fine tile (the
//   test of tile_bins, so nothing face_cover could accept is lost; the
//   z-only mode also drops faces that do not write z);
// - compact: the faces that pass are ballot-compacted in face order
//   (common.cuh block_rank);
// - stage: the block copies their flag words and rows into shared memory
//   (cp.async, every copy of a chunk in flight at once, 34.8 KB a chunk);
// - walk: every thread tests the staged faces in order from shared memory.
//   The walk only goes forward, so one staged chunk serves the whole block.
//
// DEBUG (a debug camera, raster_cuda.pack_debug_planes): each staged face's
// 18 debug planes (72 B, nine 8-byte copies) are staged beside its row and
// face_cover tests that second clip space too. Its 18.4 KB a chunk would
// take the block's shared memory past the 48 KB of static allocation, so
// they live in dynamic shared memory (DEBUG_SMEM bytes at launch, after the
// launcher's opt-in): the instantiations without DEBUG keep the static
// layout and the time they had.
//
// Per pixel the walk keeps a running minimum m and a candidate cand; for
// each covering face in face order, with zs = z*sign:
//     if (zs <= m) { cand = face; if (MODE != WALK_CLAIM && z-writing) m = zs; }
// - WALK_Z, WALK_Z_TID (K1): m starts at +inf; it ends as the final
//   z-buffer and cand as the last face with zs <= it (visibility.cu has
//   the argument). WALK_Z stages only z-writing faces, so cand is unused.
// - WALK_CLAIM (K7): m starts at the given final z-buffer value zb and is
//   never lowered, so cand ends as the last covering face with zs <= zb,
//   which is the test zb >= z*sign (tidpass.cu). Staging admits every
//   valid face by bbox, as WALK_Z_TID does: a face that writes no z may
//   still claim.
//
// Every thread of the block must call it, in the frame or not (it holds
// barriers); a thread outside the frame walks like the others and its
// caller skips the write.
#pragma once

#include "common.cuh"

enum WalkMode { WALK_Z = 0, WALK_Z_TID = 1, WALK_CLAIM = 2 };

// Dynamic shared memory of a DEBUG walk: one chunk's debug planes.
constexpr int DEBUG_SMEM = BLOCK * DBG_COLS * (int)sizeof(float);

// Opt a DEBUG walk's kernel in to DEBUG_SMEM bytes of dynamic shared
// memory: with the static rows the block passes the 48 KB that need no
// opt-in (about 55.3 KB in all). Returns the cudaError_t.
template <typename Kernel>
cudaError_t allow_debug_smem(Kernel kernel) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DEBUG_SMEM);
}

template <int MODE, bool DEBUG>
__device__ __forceinline__ void walk_faces(const float* __restrict__ fdata,
                                           const int* __restrict__ flags,
                                           const float* __restrict__ fdbg,
                                           const int* __restrict__ list,
                                           int count, int tx0, int ty0,
                                           float r, float c, float sign,
                                           float& m, int& cand) {
    __shared__ __align__(16) float s_rows[BLOCK * F_COLS];
    extern __shared__ __align__(16) float s_dbg[];
    __shared__ int s_face[BLOCK];
    __shared__ int s_flag[BLOCK];
    __shared__ int s_warp[BLOCK / 32];
    const int t = threadIdx.y * TILE + threadIdx.x;
    for (int k0 = 0; k0 < count; k0 += BLOCK) {
        const int k = k0 + t;
        int face = 0, fl = 0;
        bool hit = false;
        if (k < count) {
            face = list[k];
            fl = flags[face];
            hit = face_overlaps(fdata + (size_t)face * F_COLS, fl, tx0, ty0,
                                TILE) &&
                  (MODE != WALK_Z || (fl & FLAG_ZWRITE));
        }
        int staged;
        // block_rank's barriers also end the previous chunk's walk.
        const int pos = block_rank<BLOCK / 32>(hit, t, s_warp, &staged);
        if (hit) {
            s_face[pos] = face;
            s_flag[pos] = fl;
        }
        __syncthreads();
        // Rows are 136 bytes, 8-byte aligned (the wrappers check the base):
        // 17 copies of 8 bytes each.
        constexpr int PAIRS = F_COLS / 2;
        for (int e = t; e < staged * PAIRS; e += BLOCK) {
            const int j = e / PAIRS;
            const int off = 2 * (e - j * PAIRS);
            cp_async<8>(s_rows + j * F_COLS + off,
                        fdata + (size_t)s_face[j] * F_COLS + off);
        }
        if constexpr (DEBUG) {
            // Debug rows are 72 bytes, 8-byte aligned (the wrappers check
            // the base): 9 copies of 8 bytes each.
            constexpr int DPAIRS = DBG_COLS / 2;
            for (int e = t; e < staged * DPAIRS; e += BLOCK) {
                const int j = e / DPAIRS;
                const int off = 2 * (e - j * DPAIRS);
                cp_async<8>(s_dbg + j * DBG_COLS + off,
                            fdbg + (size_t)s_face[j] * DBG_COLS + off);
            }
        }
        cp_async_wait_all();
        __syncthreads();
        for (int j = 0; j < staged; ++j) {
            const int fj = s_flag[j];
            float z;
            if (face_cover<DEBUG>(s_rows + j * F_COLS, s_dbg + j * DBG_COLS,
                                  fj, r, c, &z)) {
                const float zs = z * sign;
                if (zs <= m) {
                    cand = s_face[j];
                    if (MODE != WALK_CLAIM && (fj & FLAG_ZWRITE)) m = zs;
                }
            }
        }
    }
}
