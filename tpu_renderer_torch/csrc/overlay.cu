// K11 overlay and K12 overlay_quantize: the debug camera's frustum drawn
// over the float64 frame and z-buffer on the card, then the frame's flip,
// gamma 0.8 and uint8.
//
// Not the counterpart of a pallas_call: the JAX package draws the overlay
// on the host (tpu_renderer/models/scene.py:824-848, ops/overlay.py), as
// the reference does (core.py:638, frustums.py:46-103). The port's plain
// versions are ops/overlay.draw_segments (K11) and numpy's
// (clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(uint8) (K12)
// (raster_cuda.overlay_plain, overlay_quantize_plain).
//
// K11 applies a segment table (ops/overlay.frustum_segments: per edge of
// the frustum, in draw order, the DDA's float64 start point and step, its
// number of points and its dashed flag) with numpy's semantics, in one
// block. Point k of a row is start + k * step in float64 (the library's
// -fmad=false keeps the product and the sum apart); a dashed row keeps the
// points with (k / 13) odd; the point's pixel is row int(p1) - 1, column
// int(p0) - 1, truncated toward zero, where -1 is the last row or column,
// as a numpy index. numpy draws a row in ten statements: the depth test
// (zb - z) * sign >= 0 over the whole row, then zb[x, y] = z, frame[x, y]
// = red, and per offset -1 and +1 the clipped neighbours' zb = z twice and
// frame = frame * 0.5 + red / 2 twice. A statement's gather precedes its
// scatter, and of several points that write one pixel the last wins.
//
// So per row, two passes with a barrier after each:
// 1. each thread tests its points against the z-buffer as the rows before
//    left it, and for each that passes, and each of the five targets it
//    writes (j = 0 the pixel, 1-4 the neighbours in statement order),
//    raises the target's owner to its stamp base + j * n + k + 1 (atomic
//    max: the last statement's last point wins, and every stamp of a row
//    lies above those of the rows before) and sets bit j of the target's
//    statement mask (atomic or);
// 2. the thread holding a target's stamp writes the target: its z, and
//    its colour from the mask: red where statement 0 wrote it, then one
//    half blend for each neighbour statement that did (a statement that
//    hits a pixel several times writes one value, which all its points
//    gathered before any of them wrote), and clears the mask.
// The owner and mask words are a zeroed scratch the wrapper allocates, two
// 32-bit words a pixel; each thread keeps its points' test results in a
// 64-bit word (at most 64 points a thread, 65,536 a row). The line pixels
// that pass the test are added to a counter on the card.
//
// K12 reads the float64 frame row by row from the bottom and writes each
// value's uint8: pow(v, 0.8) (the double pow), clipped to [0, 1], times
// 255, truncated; NaN gives 0, as numpy's cast does on the host.
//
// What bounds them on the H100: K11 is latency, not bytes: about 25 rows
// of a few hundred points, two dependent passes of global accesses each.
// K12 reads 8 B and writes 1 B a value: 60.75 MB for the 1500² frame,
// 18 us at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int OVERLAY_THREADS = 1024;
// Mirrors ops/overlay.SEG_COLS, MAX_SEGMENTS and DASH.
constexpr int SEG_COLS = 8;
constexpr int MAX_SEGMENTS = 60;
constexpr int DASH = 13;
// The pixel and its four neighbours, in numpy's statement order.
constexpr int TARGETS = 5;
constexpr int QUANTIZE_THREADS = 256;

struct Point {
    int x, y;
    double z;
};

// Point k of a segment row: false where dashing drops it.
__device__ __forceinline__ bool seg_point(const double* r, long long k,
                                          Point* p) {
    if (r[7] != 0.0 && ((k / DASH) & 1) == 0) return false;
    const double kk = (double)k;
    const double p0 = r[0] + kk * r[3];
    const double p1 = r[1] + kk * r[4];
    p->z = r[2] + kk * r[5];
    p->x = (int)p1 - 1;
    p->y = (int)p0 - 1;
    return true;
}

// A numpy index in [-n, n) as an offset.
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }

__device__ __forceinline__ int clip(int i, int n) {
    return min(max(i, 0), n - 1);
}

// Flat index of target j of point (x, y): 0 the pixel, then the rows
// x - 1 and columns y - 1, then x + 1 and y + 1, each clipped.
__device__ __forceinline__ long long target(int j, int x, int y, int h,
                                            int w) {
    int r = wrap(x, h), c = wrap(y, w);
    if (j == 1) r = clip(x - 1, h);
    if (j == 2) c = clip(y - 1, w);
    if (j == 3) r = clip(x + 1, h);
    if (j == 4) c = clip(y + 1, w);
    return (long long)r * w + c;
}

__global__ void __launch_bounds__(OVERLAY_THREADS)
overlay_kernel(const double* __restrict__ table, int rows,
               double* __restrict__ frame, double* __restrict__ zb, int h,
               int w, double sign, unsigned* __restrict__ owner,
               unsigned* __restrict__ mask,
               unsigned long long* __restrict__ counter) {
    __shared__ double seg[MAX_SEGMENTS * SEG_COLS];
    __shared__ unsigned long long drawn;
    for (int i = threadIdx.x; i < rows * SEG_COLS; i += blockDim.x)
        seg[i] = table[i];
    if (threadIdx.x == 0) drawn = 0;
    __syncthreads();

    unsigned base = 0;
    unsigned long long mine = 0;
    for (int s = 0; s < rows; ++s) {
        const double* r = seg + s * SEG_COLS;
        const long long n = (long long)r[6];
        unsigned long long keep = 0;
        // Pass 1: the depth test, then claim the targets. Owner, mask and
        // the buffers are read through L2 (ld.cg), where the atomics land.
        int i = 0;
        for (long long k = threadIdx.x; k < n; k += blockDim.x, ++i) {
            Point p;
            if (!seg_point(r, k, &p)) continue;
            const double old = __ldcg(zb + target(0, p.x, p.y, h, w));
            if (!((old - p.z) * sign >= 0.0)) continue;
            keep |= 1ull << i;
            ++mine;
#pragma unroll
            for (int j = 0; j < TARGETS; ++j) {
                const long long t = target(j, p.x, p.y, h, w);
                atomicMax(owner + t, base + (unsigned)(j * n + k) + 1u);
                atomicOr(mask + t, 1u << j);
            }
        }
        __syncthreads();
        // Pass 2: each target's last writer writes it.
        i = 0;
        for (long long k = threadIdx.x; k < n; k += blockDim.x, ++i) {
            if (!((keep >> i) & 1)) continue;
            Point p;
            seg_point(r, k, &p);
#pragma unroll
            for (int j = 0; j < TARGETS; ++j) {
                const long long t = target(j, p.x, p.y, h, w);
                if (__ldcg(owner + t) != base + (unsigned)(j * n + k) + 1u)
                    continue;
                const unsigned m = __ldcg(mask + t);
                __stcg(mask + t, 0u);
                zb[t] = p.z;
                double* f = frame + 3 * t;
                double c0 = __ldcg(f), c1 = __ldcg(f + 1), c2 = __ldcg(f + 2);
                if (m & 1u) c0 = 1.0, c1 = 0.0, c2 = 0.0;
                for (int b = 1; b < TARGETS; ++b) {
                    if ((m >> b) & 1u) {
                        c0 = c0 * 0.5 + 0.5;
                        c1 = c1 * 0.5 + 0.0;
                        c2 = c2 * 0.5 + 0.0;
                    }
                }
                f[0] = c0;
                f[1] = c1;
                f[2] = c2;
            }
        }
        __syncthreads();
        base += (unsigned)(TARGETS * n);
    }
    atomicAdd(&drawn, mine);
    __syncthreads();
    if (threadIdx.x == 0 && drawn) atomicAdd(counter, drawn);
}

// One value a thread; block row y writes output row y from frame row
// h - 1 - y.
__global__ void __launch_bounds__(QUANTIZE_THREADS)
overlay_quantize_kernel(const double* __restrict__ frame,
                        unsigned char* __restrict__ out, int h, int row) {
    const int c = blockIdx.x * QUANTIZE_THREADS + threadIdx.x;
    if (c >= row) return;
    const long long y = blockIdx.y;
    const double v = pow(__ldcs(frame + (h - 1 - y) * row + c), 0.8);
    const double q = fmin(fmax(v, 0.0), 1.0) * 255.0;
    out[y * row + c] = v != v ? 0 : (unsigned char)(int)q;
}

}  // namespace

// table: (rows, SEG_COLS) float64 on the card, rows <= MAX_SEGMENTS, each
// of at most 65,536 points; frame (H, W, 3) and zb (H, W) float64, written
// in place; sign ±1; scratch: 2 * H * W zeroed 32-bit words; counter: one
// int64 the line pixels are added to.
TR_EXPORT int tr_overlay(const double* table, int rows, double* frame,
                         double* zb, int height, int width, double sign,
                         unsigned* scratch, unsigned long long* counter,
                         void* stream) {
    if (rows < 0 || rows > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
    const long long pixels = (long long)height * width;
    overlay_kernel<<<1, OVERLAY_THREADS, 0, (cudaStream_t)stream>>>(
        table, rows, frame, zb, height, width, sign, scratch,
        scratch + pixels, counter);
    return (int)cudaGetLastError();
}

// frame (H, W, 3) float64; out (H, W, 3) uint8, rows flipped.
TR_EXPORT int tr_overlay_quantize(const double* frame, unsigned char* out,
                                  int height, int width, void* stream) {
    if (height <= 0 || width <= 0) return (int)cudaSuccess;
    const int row = 3 * width;
    const dim3 grid((row + QUANTIZE_THREADS - 1) / QUANTIZE_THREADS, height);
    overlay_quantize_kernel<<<grid, QUANTIZE_THREADS, 0,
                              (cudaStream_t)stream>>>(frame, out, height,
                                                      row);
    return (int)cudaGetLastError();
}
