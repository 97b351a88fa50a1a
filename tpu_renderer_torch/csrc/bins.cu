// Coarse binning of faces (K1) and shadow quads (K4) on the card, with no
// host synchronisation.
//
// Counterpart of the JAX package's bin_primitives (raster_pallas.py:123-141)
// at coarse granularity, for K1's and K4's wrappers, which no longer call
// raster_cuda.tile_bins: its dense (tiles x primitives) mask and
// torch.nonzero made the host wait for the device once per call, and the
// frame is host-bound.
//
// One block of BIN_THREADS threads per COARSE x COARSE tile of the frame's
// rows from row0. The block scans the table in chunks of BIN_THREADS rows;
// each thread tests one row's bbox and active word against the tile (the
// test of tile_bins, common.cuh face_overlaps / quad_overlaps), and the
// rows that pass are appended in table order by a block-wide prefix sum
// over __ballot_sync (common.cuh block_rank). Tile t's list is items[t*n :
// t*n + counts[t]]: its capacity is the table's row count n, as
// bin_primitives' "capacity equals N", so no overlap is ever dropped and
// every buffer's size is known on the host (coarse tiles x rows). A
// primitive that overlaps a fine tile overlaps the coarse tile that holds
// it, so K1 and K4 refine these lists to their 16 x 16 tiles losslessly.
//
// The quad kind scans only the first min(*n_rows, n) rows when K4's
// wrapper gives it the silhouette count (n_rows, read on the card, as K8
// reads it): the JAX package bins only the compacted prefix too
// (pipeline.py:903-920 there). The capacity, and so the lists' stride and
// the scratch, stays n, which the host knows.
//
// What bounds it on the H100: latency, not bytes. Each block reads every
// row's bbox (16-20 bytes, from L2 after the first block) in n /
// BIN_THREADS dependent steps of load, ballot and two barriers; at 1024^2
// the grid is 64 blocks, so the step count, not the card's width, sets its
// time. The design keeps that count small with 1024-thread chunks.
#include "common.cuh"

namespace {

constexpr int BIN_THREADS = 1024;

template <int KIND>
__global__ void __launch_bounds__(BIN_THREADS)
    coarse_bins_kernel(const float* __restrict__ fdata,
                       const int* __restrict__ words, int n,
                       const int* __restrict__ n_rows, int row0,
                       int* __restrict__ counts, int* __restrict__ items) {
    __shared__ int warp_counts[BIN_THREADS / 32];
    const int x0 = blockIdx.x * COARSE;
    const int y0 = row0 + blockIdx.y * COARSE;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* list = items + (size_t)tile * n;
    const int rows = n_rows == nullptr ? n : min(max(*n_rows, 0), n);
    int base = 0;
    for (int i0 = 0; i0 < rows; i0 += BIN_THREADS) {
        const int i = i0 + threadIdx.x;
        bool hit = false;
        if (i < rows) {
            if constexpr (KIND == BIN_FACES)
                hit = face_overlaps(fdata + (size_t)i * F_COLS, words[i], x0,
                                    y0, COARSE);
            else
                hit = quad_overlaps(words + (size_t)i * QI_COLS, x0, y0,
                                    COARSE);
        }
        int total;
        const int pos = block_rank<BIN_THREADS / 32>(hit, threadIdx.x,
                                                     warp_counts, &total);
        if (hit) list[base + pos] = i;
        base += total;
    }
    if (threadIdx.x == 0) counts[tile] = base;
}

}  // namespace

int launch_coarse_bins(int kind, const float* fdata, const int* words, int n,
                       const int* n_rows, int height, int width, int row0,
                       int* counts, int* items, cudaStream_t stream) {
    const dim3 grid((width + COARSE - 1) / COARSE,
                    (height + COARSE - 1) / COARSE);
    if (kind == BIN_FACES)
        coarse_bins_kernel<BIN_FACES><<<grid, BIN_THREADS, 0, stream>>>(
            fdata, words, n, n_rows, row0, counts, items);
    else
        coarse_bins_kernel<BIN_QUADS><<<grid, BIN_THREADS, 0, stream>>>(
            fdata, words, n, n_rows, row0, counts, items);
    return (int)cudaGetLastError();
}

TR_EXPORT int tr_coarse_bins(int kind, const float* fdata, const int* words,
                             int n, const int* n_rows, int height, int width,
                             int row0, int* counts, int* items,
                             void* stream) {
    return launch_coarse_bins(kind, fdata, words, n, n_rows, height, width,
                              row0, counts, items, (cudaStream_t)stream);
}
