// K6 lines: the wireframe mask against the final z-buffer.
//
// Replaces tpu_renderer/ops/raster_pallas.py lines_pallas (:2561, kernel
// body :2600-2642; tables from pack_lines :2507).
//
// A pixel is lit iff some active edge's right-to-left DDA pixel lands on it
// inside the edge's bbox and inside 0 < row < h-1, 0 < col < w-1, and the
// strict ``zbuf - z > 0`` test passes (no handedness sign: the reference
// shader hard-codes ``> 0``). The DDA is inverted in closed form
// (raster_cuda.lines_plain, the gather over every pixel): along the major
// axis the step is exactly -1 in x or +-1 in y, so for pixel (r, c)
//   major x: kk = floor(x0 - c),                        other = floor(y0 + kk*sy) - r
//   major y: kk = sy > 0 ? ceil(r - y0) : floor(y0 - r), other = floor(x0 + kk*sx) - c
// and the pixel is lit by the edge iff other == 0, 0 <= kk < nsteps, the
// bbox and interior tests hold and zbuf - (z0 + kk*sz) > 0.
//
// Scatter instead of gather, exactly. kk depends on the major coordinate
// alone, and so does F = floor(y0 + kk*sy) (major x) or floor(x0 + kk*sx)
// (major y). other = F - (minor coordinate). IEEE subtraction of two finite
// floats is 0 only when they are equal (subnormals are kept: no fast math,
// no flush to zero), and inf - v or NaN - v is never 0. So at each major
// coordinate at most one pixel can pass, the one whose minor coordinate
// equals F, and only if F is finite (a finite floor is integer-valued).
// Each lane computes kk and F with the gather's float ops in its order and
// tests that one candidate with the whole predicate: F against the bbox and
// the interior as floats BEFORE any cast to an index, so an inf, NaN or
// out-of-range F fails exactly where the gather's other == 0 fails; then
// kk, then the z test at the candidate pixel. The major coordinates visited
// are the bbox's, cut to the interior (1 <= i <= extent - 2, which is what
// the interior test accepts); every other major coordinate fails the
// gather's bbox or interior test. So the lit set equals the gather's.
// Every writer stores the same 1 after one clearing launch: no atomics.
//
// What bounds it on the H100: bytes, barely (1.5 us of needed bytes at
// 1024^2: the mask out, the edge rows, zbuf where an edge lands); at these
// sizes, launch and latency. Before this design one thread per pixel
// walked its 16x16 tile's bbox-binned edge list, a chain of dependent
// global loads per visit, work growing as pixels x listed edges (the
// floor's long edges land in dozens of tile lists), and the lists came from
// torch with a host sync. Design: no binning at all. One launch clears the
// mask; then one warp per active edge, its lanes striding over the edge's
// major-axis extent, so the work is the sum of the edges' extents (a few
// pixels each for a mesh, up to the frame's width for the floor), and the
// grid is known on the host. -fmad=false keeps the float ops bit-identical
// to the plain version.
#include "common.cuh"

namespace {

constexpr int L_COLS = 8;       // x0 y0 z0 sx sy sz nsteps majx (pack_lines)
constexpr int LINE_WARPS = 8;   // edges per block, one warp each
constexpr int CLEAR_THREADS = 256;

__global__ void __launch_bounds__(CLEAR_THREADS)
    lines_clear_kernel(int* __restrict__ mask, size_t n) {
    const size_t i = (size_t)blockIdx.x * CLEAR_THREADS + threadIdx.x;
    if (i < n) mask[i] = 0;
}

__global__ void __launch_bounds__(LINE_WARPS * 32)
    lines_kernel(const float* __restrict__ ldata,
                 const int* __restrict__ lbbox,
                 const bool* __restrict__ active, int n_edges,
                 const float* __restrict__ zbuf, int height, int width,
                 int* __restrict__ mask) {
    const int e = blockIdx.x * LINE_WARPS + threadIdx.x / 32;
    if (e >= n_edges || !active[e]) return;
    const float* d = ldata + (size_t)e * L_COLS;
    const int* bb = lbbox + (size_t)e * 4;
    const float x0 = d[0], y0 = d[1], z0 = d[2];
    const float sx = d[3], sy = d[4], sz = d[5], nsteps = d[6];
    const bool majx = d[7] > 0.0f;
    // Major axis: its integers in the bbox and the interior. Minor axis:
    // the bbox and interior bounds F is compared with, as floats.
    const int lo = max(majx ? bb[0] : bb[2], 1);
    const int hi = min(majx ? bb[1] : bb[3], (majx ? width : height) - 1);
    const float f_lo = static_cast<float>(majx ? bb[2] : bb[0]);
    const float f_hi = static_cast<float>(majx ? bb[3] : bb[1]);
    const float f_max = static_cast<float>(majx ? height : width) - 1.0f;
    for (int i = lo + (threadIdx.x & 31); i < hi; i += 32) {
        const float a = static_cast<float>(i);
        float kk, f;
        if (majx) {
            kk = floorf(x0 - a);
            f = floorf(y0 + kk * sy);
        } else {
            kk = sy > 0.0f ? ceilf(a - y0) : floorf(y0 - a);
            f = floorf(x0 + kk * sx);
        }
        if (!(f >= f_lo && f < f_hi && f > 0.0f && f < f_max && kk >= 0.0f &&
              kk < nsteps))
            continue;
        const int j = static_cast<int>(f);
        const size_t p = majx ? (size_t)j * width + i : (size_t)i * width + j;
        const float z = z0 + kk * sz;
        if (zbuf[p] - z > 0.0f) mask[p] = 1;
    }
}

}  // namespace

TR_EXPORT int tr_lines(const float* ldata, const int* lbbox,
                       const bool* active, int n_edges, const float* zbuf,
                       int height, int width, int* mask, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const size_t n = (size_t)height * width;
    if (n == 0) return 0;
    lines_clear_kernel<<<(unsigned)((n + CLEAR_THREADS - 1) / CLEAR_THREADS),
                         CLEAR_THREADS, 0, st>>>(mask, n);
    const int rc = (int)cudaGetLastError();
    if (rc != 0 || n_edges == 0) return rc;
    lines_kernel<<<(n_edges + LINE_WARPS - 1) / LINE_WARPS, LINE_WARPS * 32, 0,
                   st>>>(ldata, lbbox, active, n_edges, zbuf, height, width,
                         mask);
    return (int)cudaGetLastError();
}
