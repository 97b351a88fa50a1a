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
// What bounds it on the H100: neither bytes (1.3 us of needed bytes at
// 1024^2) nor the card's arithmetic rate, but latency, led by the per-pixel
// walk over the quads staged for a tile. Shadow quads are long slivers, so
// their bbox lists are long and most listed quads miss a given tile. Before
// this design each (pixel, quad) visit was a chain of dependent
// global loads (list entry, qi row, 44-float row), over the bbox lists,
// and the lists came from torch with a host sync. Design:
// - lists from csrc/bins.cu (coarse tiles, on the card, no host sync);
// - one 16x16 block per tile, one thread per pixel. The block first reads
//   its 256 z values; if none is geometry (threads outside the frame count
//   as background) it writes zeros and returns, all threads together after
//   the block's only barrier so far;
// - otherwise it walks its coarse tile's list in chunks of BLOCK quads. Each
//   thread tests one quad: ok and bbox against the fine tile (as tile_bins),
//   then the exact edge cull below. The quads that pass are compacted in
//   list order and their rows (A, B, K, the depth plane; n and front)
//   staged in shared memory by cp.async, every copy of a chunk in flight at
//   once (41 words a quad, 42 KB a chunk); each geometry pixel then sums +-1
//   over the staged quads, edge loop left at the first edge that fails, so
//   the tiles with the longest staged lists set the kernel's time. Op-by-op
//   rounding (-fmad=false) keeps the per-pixel test bit-identical to the
//   plain version (shadow.quad_fragments).
//
// Exact edge cull. The per-pixel edge value is e = ((A*c) + (B*r)) + K at
// integer pixel coordinates c, r >= 0. With round-to-nearest, each product
// and each sum is monotone (non-decreasing) in each argument, so over the
// tile's pixels [tx0, tx0+15] x [ty0, ty0+15] (ty0 including row0) e is
// largest at one corner: c* = tx0+15 if A >= 0 else tx0, r* = ty0+15 if
// B >= 0 else ty0. If e(c*, r*) is not > 0 for some active edge, no pixel of
// the tile is inside, and the quad is dropped; pixels past the frame's edge
// only widen the set the maximum is taken over. Infinities and NaN keep
// this exact: NaN A, B or K makes e NaN at every pixel; A = -inf with c* =
// tx0 = 0 gives NaN at the corner and -inf or NaN elsewhere; and where the
// corner's sum is inf + -inf, the term that is -inf at its maximum is -inf
// (or NaN) at every pixel, so no pixel's e is > 0. Every case that makes
// the corner fail makes every pixel fail (tests/test_torch_binning.py holds
// the plain version of this cull to quad_fragments on random and
// non-finite quads). It is the port's exact counterpart of JAX's corner-max
// prune (raster_pallas.py:811-832) and needs no slack. JAX's z-occlusion
// prune (:844-869) is left out.
//
// The rows start at row0 (a block of frame rows, pixel math in global
// coordinates), and so do the quads' tile lists. With a count n_rows (K8's
// silhouette count, on the card; null: every row), the lists hold only
// the table's first *n_rows rows, so K4's work follows the count.
//
// The depth constants (nf2, fpn, fmn) = (2*near*far, far+near, far-near),
// float32 values composed on the host (raster_cuda.stencil_scalars), are
// read through a device pointer, zc[0:3], and not passed by value: a frame
// captured into a CUDA graph (ops/compiled.py) replays with the camera's
// near and far of each frame, which a by-value argument would freeze.
// sign * nf2 is exact for sign = +-1, so the test is the one the plain
// version evaluates.
#include "common.cuh"

namespace {

// A staged quad: qdata's first 40 columns ([0:12] A, [12:24] B, [24:36] K,
// 36-38 zx zy zd, 39 zero), copied as ten 16-byte pieces (qdata's rows are
// 176 bytes, 16-byte aligned: the wrapper checks the base), and a word
// n | SQ_FRONT.
constexpr int SQ_COLS = 40;
constexpr int SQ_FRONT = 16;

__device__ __forceinline__ int active_edges(const int* __restrict__ qq) {
    return min(max(qq[4], 0), 12);
}

// False when no pixel of the tile at (tx0, ty0) can be inside the quad's
// first n edges (the corner test above).
__device__ __forceinline__ bool tile_may_cover(const float* __restrict__ d,
                                               int n, int tx0, int ty0) {
    for (int i = 0; i < n; ++i) {
        const float a = d[i], b = d[12 + i];
        const float c = static_cast<float>(a >= 0.0f ? tx0 + TILE - 1 : tx0);
        const float r = static_cast<float>(b >= 0.0f ? ty0 + TILE - 1 : ty0);
        if (!(a * c + b * r + d[24 + i] > 0.0f)) return false;
    }
    return true;
}

__global__ void __launch_bounds__(BLOCK)
    stencil_kernel(const float* __restrict__ qdata, const int* __restrict__ qi,
                   const int* __restrict__ bin_counts,
                   const int* __restrict__ bin_items, int n_quads,
                   const float* __restrict__ zb_sign, int height, int width,
                   int row0, float sign, const float* __restrict__ zc,
                   int* __restrict__ out) {
    __shared__ __align__(16) float s_q[BLOCK * SQ_COLS];
    __shared__ int s_idx[BLOCK];
    __shared__ int s_word[BLOCK];
    __shared__ int s_warp[BLOCK / 32];
    const int t = threadIdx.y * TILE + threadIdx.x;
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    const bool in_frame = row < height && col < width;
    const size_t p = (size_t)row * width + col;
    const float zb = in_frame ? zb_sign[p] : INFINITY;
    const bool geometry = zb < 3e38f;
    if (!__syncthreads_or(geometry)) {
        if (in_frame) out[p] = 0;
        return;
    }
    const float sign_nf2 = sign * zc[0];
    const float fpn = zc[1];
    const float fmn = zc[2];
    const int tx0 = blockIdx.x * TILE;
    const int ty0 = row0 + blockIdx.y * TILE;
    const float r = static_cast<float>(row0 + row);
    const float c = static_cast<float>(col);
    const int ct = coarse_tile_of_block(width);
    const int count = bin_counts[ct];
    const int* list = bin_items + (size_t)ct * n_quads;

    int acc = 0;
    for (int k0 = 0; k0 < count; k0 += BLOCK) {
        const int k = k0 + t;
        int q = 0, qword = 0;
        bool hit = false;
        if (k < count) {
            q = list[k];
            const int* qq = qi + (size_t)q * QI_COLS;
            const int n = active_edges(qq);
            hit = quad_overlaps(qq, tx0, ty0, TILE) &&
                  tile_may_cover(qdata + (size_t)q * Q_COLS, n, tx0, ty0);
            qword = n | (qq[6] > 0 ? SQ_FRONT : 0);
        }
        int staged;
        // block_rank's barriers also end the previous chunk's walk.
        const int pos = block_rank<BLOCK / 32>(hit, t, s_warp, &staged);
        if (hit) {
            s_idx[pos] = q;
            s_word[pos] = qword;
        }
        __syncthreads();
        constexpr int PIECES = SQ_COLS / 4;
        for (int e = t; e < staged * PIECES; e += BLOCK) {
            const int j = e / PIECES;
            const int k4 = 4 * (e - j * PIECES);
            cp_async<16>(s_q + j * SQ_COLS + k4,
                         qdata + (size_t)s_idx[j] * Q_COLS + k4);
        }
        cp_async_wait_all();
        __syncthreads();
        if (!geometry) continue;
        for (int j = 0; j < staged; ++j) {
            const float* d = s_q + j * SQ_COLS;
            const int word = s_word[j];
            const int n = word & (SQ_FRONT - 1);
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
                acc += (word & SQ_FRONT) ? 1 : -1;
        }
    }
    if (in_frame) out[p] = acc;
}

}  // namespace

TR_EXPORT int tr_stencil(const float* qdata, const int* qi, int n_quads,
                         const int* n_rows, int* bin_counts, int* bin_items,
                         const float* zb_sign, int height, int width, int row0,
                         float sign, const float* zc, int* stencil,
                         void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int rc =
        launch_coarse_bins(BIN_QUADS, nullptr, qi, n_quads, n_rows, height,
                           width, row0, bin_counts, bin_items, st);
    if (rc != 0) return rc;
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    stencil_kernel<<<grid, block, 0, st>>>(
        qdata, qi, bin_counts, bin_items, n_quads, zb_sign, height, width,
        row0, sign, zc, stencil);
    return (int)cudaGetLastError();
}
