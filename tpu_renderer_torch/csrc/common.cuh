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
// Threads of a raster block, and rows staged per chunk by K1 and K4.
constexpr int BLOCK = TILE * TILE;
// Edge of K1's and K4's coarse binning tiles (csrc/bins.cu), a multiple of
// TILE (raster_cuda.COARSE mirrors it).
constexpr int COARSE = 128;
static_assert(COARSE % TILE == 0, "a coarse tile holds whole fine tiles");

// Packed face table (raster_cuda.pack_faces).
constexpr int F_AFF = 0;     // av bv cv aw bw cw az bz cz
constexpr int F_INV_W = 9;   // 1/w per vertex
constexpr int F_BBOX = 12;   // x0 x1 y0 y1 as float
constexpr int F_CLIP = 16;   // e[i][j] at 16 + 6*i + j
constexpr int F_COLS = 34;
// The debug camera's planes (raster_cuda.pack_debug_planes), a (G, 18)
// table of their own: e_dbg[i][j] at 6*i + j, pre-scaled as F_CLIP's.
constexpr int DBG_COLS = 18;

constexpr int FLAG_VALID = 1;
constexpr int FLAG_ZWRITE = 4;
constexpr int FLAG_PPC = 8;

constexpr int A_COLS = 42;   // per-face shading attributes (pack_face_attrs)
constexpr int GB_CHANNELS = 32;
constexpr int Q_COLS = 44;   // quad table (pack_quads)
constexpr int QI_COLS = 8;

// One row vector times a row-major 4x4 matrix, summed left to right
// (vertex._rowvec).
__device__ __forceinline__ float4 rowvec(float4 v, const float* m) {
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
        out[c] = ((v.x * m[c] + v.y * m[4 + c]) + v.z * m[8 + c]) +
                 v.w * m[12 + c];
    return make_float4(out[0], out[1], out[2], out[3]);
}

// The six linearized plane conditions of one clip space at barycentrics
// (u, v, w): q_j = u*e[j] + v*e[6 + j] + w*e[12 + j] for the pre-scaled
// planes e, each (q_j > 0) == s_pos. A NaN q fails q > 0, as in
// raster_pallas._face_tile_cov.
__device__ __forceinline__ bool inside_space(const float* __restrict__ e,
                                             float u, float v, float w,
                                             bool s_pos) {
    for (int j = 0; j < 6; ++j) {
        const float q = u * e[j] + v * e[6 + j] + w * e[12 + j];
        if ((q > 0.0f) != s_pos) return false;
    }
    return true;
}

// Coverage and depth of one face at pixel (r, c): the barycentric inside
// test u, v, w >= 0 from the affine coefficients, the integer bbox window,
// validity, and — for faces flagged FLAG_PPC — the linearized per-pixel clip
// test (q_j > 0) == (S > 0), S != 0 (raster_pallas._face_tile_cov), over
// the camera's planes and, with DEBUG, then the debug camera's planes `fd`
// (the face's DBG_COLS row; unread without DEBUG). The conditions are ANDed,
// so stopping at the first that fails gives the plain version's answer.
template <bool DEBUG>
__device__ __forceinline__ bool face_cover(const float* __restrict__ f,
                                           const float* __restrict__ fd,
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
        if (!inside_space(f + F_CLIP, u, v, w, s_pos)) return false;
        if (DEBUG && !inside_space(fd, u, v, w, s_pos)) return false;
    }
    *z = f[6] * c + f[7] * r + f[8];
    return true;
}

// Bbox overlap of a tile whose first pixel is (x0, y0) and whose edge is
// `edge` px: tile_bins' test. A face's bbox is its packed float window
// (integer-valued; compared as floats, the tile's edges are exact), so a
// face that face_cover accepts at some pixel of the tile always passes; it
// must be valid too. A quad's bbox is qi[0:4], and it must be active.
__device__ __forceinline__ bool face_overlaps(const float* __restrict__ f,
                                              int flags, int x0, int y0,
                                              int edge) {
    const float b0 = f[F_BBOX], b1 = f[F_BBOX + 1], b2 = f[F_BBOX + 2],
                b3 = f[F_BBOX + 3];
    return (flags & FLAG_VALID) && b0 < (float)(x0 + edge) &&
           b1 > (float)x0 && b2 < (float)(y0 + edge) && b3 > (float)y0;
}

__device__ __forceinline__ bool quad_overlaps(const int* __restrict__ q,
                                              int x0, int y0, int edge) {
    return q[5] > 0 && q[0] < x0 + edge && q[1] > x0 && q[2] < y0 + edge &&
           q[3] > y0;
}

// Block-wide ordered compaction: this thread's rank among the threads of
// the block whose `flag` is set, in thread order, and their number in
// *total. `t` is the thread's linear index; every thread of the block (a
// multiple of 32, NWARPS warps) must call it. A warp ballot gives the rank
// inside the warp, a prefix over the per-warp counts in shared memory the
// warp's base. The second barrier lets the caller reuse `warp_counts` and
// write what the previous call's ranks addressed.
template <int NWARPS>
__device__ __forceinline__ int block_rank(bool flag, int t, int* warp_counts,
                                          int* total) {
    const int lane = t & 31, warp = t >> 5;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
        const int c = warp_counts[w];
        before += w < warp ? c : 0;
        sum += c;
    }
    __syncthreads();
    *total = sum;
    return before + __popc(ballot & ((1u << lane) - 1u));
}

// cp.async (sm_80 and later): a copy of BYTES (8 or 16, both addresses
// aligned to it) from global to shared memory that takes no register and
// does not stall the thread; all of a thread's copies complete at
// cp_async_wait_all(), and a barrier after it publishes them to the block.
// K1 and K4 stage rows with it, so a thread keeps every load of its share
// of a chunk in flight at once.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    static_assert(BYTES == 8 || BYTES == 16, "cp.async copies 8 or 16 bytes");
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Coarse binning on the card (csrc/bins.cu): kind BIN_FACES bins the
// packed face table `fdata` by its valid flag word `words` (flags), kind
// BIN_QUADS the quads by `words` = qi, over tiles of COARSE x COARSE
// pixels: every raster block of a coarse tile refines its list to its own
// TILE x TILE tile. Tile t of the grid over `height` rows from row0 lists
// items[t*n : t*n + counts[t]], ascending; the capacity n per tile means no
// overlap is ever dropped. A non-null n_rows (a count on the card) limits
// the scan to the first min(*n_rows, n) rows. Returns the launch's
// cudaError_t.
enum BinKind { BIN_FACES = 0, BIN_QUADS = 1 };
int launch_coarse_bins(int kind, const float* fdata, const int* words, int n,
                       const int* n_rows, int height, int width, int row0,
                       int* counts, int* items, cudaStream_t stream);

// The coarse tile of a raster block of TILE x TILE pixels.
__device__ __forceinline__ int coarse_tile_of_block(int width) {
    constexpr int per = COARSE / TILE;
    return (blockIdx.y / per) * ((width + COARSE - 1) / COARSE) +
           blockIdx.x / per;
}
