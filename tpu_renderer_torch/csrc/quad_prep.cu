// K8 quad_prep: clip, project and pack the silhouette shadow quads into K4's
// tables, as many as the silhouette count on the card says.
//
// Not the counterpart of a pallas_call: the JAX package computes this in
// XLA (tpu_renderer/ops/shadow.py:262-339, prepare_quads' compacted _prep)
// and packs with raster_pallas.pack_quads (:903). There the silhouette
// edges come first (argsort(~sil, stable=True)) and only a static prefix
// is clipped and packed, its length picked by lax.cond from a ladder of
// capacities (E/5, E/3, E), because XLA needs static shapes. Torch ops
// have static shapes too and a CUDA graph cannot branch, so without a
// kernel that reads the count on the card the port would either wait for
// the host (no replay may) or keep such a ladder. This kernel reads the
// count through a pointer, n_rows, so a captured frame replays with any
// count and does the work of that count only.
//
// Design: a half-warp (a group of 16 lanes) per quad, the polygon in
// registers. Lane j of a group holds slot j of the polygon (j < QUAD_PMAX;
// lanes 12-15 hold the zero vertex and emit nothing), so a warp prepares
// two quads. For the table row i < *n_rows it reads quad[order[i]] and
// - clips it against the six frustum planes in Sutherland-Hodgman passes,
//   in ops/frustum._clip_one_plane's append order. Per pass every lane
//   takes its next vertex from lane j + 1 by a shuffle (lane 0 where the
//   polygon wraps), forms its two candidates (its vertex if visible, then
//   the intersection from the next vertex toward it on a visibility
//   change; a segment with |denominator| < 1e-10 or a weight outside
//   [0, 1] adds none), and finds where they go as the exclusive prefix of
//   the emitted candidates over the lanes below it (two ballots and a
//   popcount: the plain version's cumsum over the interleaved flags). The
//   emitted vertices move through a 12-slot stage in shared memory, one
//   per group and pass, ping-ponging between two so that one __syncwarp
//   orders each pass; slots past the new count read as zero. The count is
//   the total, which may run past QUAD_PMAX as the plain version's does
//   (the slots stop there);
// - projects slot j on lane j: row vector times MVP, divided by w (all
//   four components), times the viewport (shadow.clip_project; slots past
//   the count are the zero vertex, whose projection is NaN, as in the
//   plain version);
// - packs the row as raster_cuda.pack_quads does: the depth plane from
//   slots 0-2 (shuffles), the bbox as a butterfly of min/max over the
//   active lanes, clamped, ceiled and zeroed where not finite, edge
//   coefficients (shadow.quad_edge_coeffs) of lane j and its neighbour,
//   over the nan_to_num'd screen x and y, box_valid, is_front; ok is
//   count >= 3. Lanes 0-11 write columns j, 12 + j and 24 + j, lanes 0-7
//   columns 36 + j and qi[j].
// A persistent grid, sized from the card (SMs times the resident blocks,
// tr_quad_prep_blocks, queried once by the wrapper), loops its groups over
// the rows below the count, so one captured launch serves every count; the
// same launch writes every row from *n_rows to the capacity as zeros in
// 16-byte stores (rows are 176 and 32 bytes), so no row from an earlier
// frame or replay reaches K4, and the tables equal the plain version's
// over all cap rows.
//
// Bit-identity with the plain version (quad_prep_plain) comes from the
// library's -fmad=false, __fdiv_rn for every division the plain version
// makes (the clip weight, the divide by w, the depth plane), and sums in
// the plain version's left-to-right order; the shuffles and the stage move
// values verbatim. The reductions follow torch's NaN rules: amin/amax and
// clamp propagate NaN; the float-to-int cast saturates as torch's does on
// the card. The butterfly's min/max of non-NaN values is the same value in
// any order up to the sign of a zero, which nothing downstream keeps: the
// clamp's compares, ceilf and the int cast give 0 for either zero, the
// float bbox columns are that int, and box_valid compares with > only.
//
// What bounds it on the H100: a row's work is one group's dependent chain
// (six passes of shuffles, a division, two ballots and a stage round trip,
// then the projection and pack), about a microsecond; every row below the
// count runs at once when the count is under the grid's groups. Beyond
// that, bytes: 68 B read and 208 B written per silhouette row, and 208 B
// written per zero row past the count, which at the crowd's capacity is
// most of the launch's bytes.
#include "common.cuh"

namespace {

constexpr int QUAD_PMAX = 12;  // shadow.QUAD_PMAX
constexpr int GROUP = 16;      // lanes per quad
constexpr int PREP_THREADS = 256;
constexpr int GROUPS_PER_BLOCK = PREP_THREADS / GROUP;
constexpr unsigned FULL = 0xffffffffu;
static_assert(QUAD_PMAX <= GROUP, "a lane per slot");
static_assert((Q_COLS * 4) % 16 == 0 && (QI_COLS * 4) % 16 == 0,
              "table rows are whole 16-byte words");

__device__ __forceinline__ float dot4(float4 a, const float* p) {
    return ((a.x * p[0] + a.y * p[1]) + a.z * p[2]) + a.w * p[3];
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
    return make_float4(__shfl_sync(FULL, v.x, src, GROUP),
                       __shfl_sync(FULL, v.y, src, GROUP),
                       __shfl_sync(FULL, v.z, src, GROUP),
                       __shfl_sync(FULL, v.w, src, GROUP));
}

// torch.amin / amax: NaN if any operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// torch.nan_to_num(x, nan=0, posinf=3e38, neginf=-3e38).
__device__ __forceinline__ float nan_to_num(float x) {
    if (isnan(x)) return 0.0f;
    if (isinf(x)) return x > 0.0f ? 3e38f : -3e38f;
    return x;
}

// Slot j's lane of the next vertex: j + 1, or 0 where the polygon wraps.
__device__ __forceinline__ int next_slot(int j, int count) {
    return (j + 1 >= count || j + 1 == QUAD_PMAX) ? 0 : j + 1;
}

// One Sutherland-Hodgman pass of the group's polygon: lane j's slot `v`
// of `count` active vertices (count may exceed QUAD_PMAX; the slots stop
// there) becomes slot j of the clipped polygon, zero past its count, which
// it returns. `shift` is the group's first lane in the warp, `stage` its
// 12-slot buffer for this pass.
__device__ __forceinline__ int clip_pass(float4& v, int count,
                                         const float* plane, int j,
                                         int shift, float4* stage) {
    const bool active = j < QUAD_PMAX && j < count;
    const float4 nxt = shfl4(v, next_slot(j, count));
    const float dist_cur = dot4(v, plane);
    const float dist_nxt = dot4(nxt, plane);
    const bool cur_vis = dist_cur >= 0.0f;
    const bool nxt_vis = dist_nxt >= 0.0f;
    const float4 dir = make_float4(v.x - nxt.x, v.y - nxt.y, v.z - nxt.z,
                                   v.w - nxt.w);
    const float denom = dot4(dir, plane);
    const bool parallel = fabsf(denom) < 1e-10f;
    const float weight = __fdiv_rn(-dist_nxt, parallel ? 1.0f : denom);
    const bool emit_cur = active && cur_vis;
    const bool emit_ip = active && cur_vis != nxt_vis && !parallel &&
                         weight >= 0.0f && weight <= 1.0f;
    const unsigned m_cur = (__ballot_sync(FULL, emit_cur) >> shift) & 0xffffu;
    const unsigned m_ip = (__ballot_sync(FULL, emit_ip) >> shift) & 0xffffu;
    const unsigned below = (1u << j) - 1u;
    const int pos = __popc(m_cur & below) + __popc(m_ip & below);
    if (emit_cur && pos < QUAD_PMAX) stage[pos] = v;
    const int pos_ip = pos + (emit_cur ? 1 : 0);
    if (emit_ip && pos_ip < QUAD_PMAX)
        stage[pos_ip] = make_float4(nxt.x + weight * dir.x,
                                    nxt.y + weight * dir.y,
                                    nxt.z + weight * dir.z,
                                    nxt.w + weight * dir.w);
    __syncwarp();
    const int out = __popc(m_cur) + __popc(m_ip);
    v = (j < QUAD_PMAX && j < out) ? stage[j]
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return out;
}

__global__ void __launch_bounds__(PREP_THREADS)
    quad_prep_kernel(const float* __restrict__ quad,
                     const int* __restrict__ order, int cap,
                     const int* __restrict__ n_rows,
                     const float* __restrict__ planes,
                     const float* __restrict__ mvp,
                     const float* __restrict__ viewport, int height,
                     int width, float* __restrict__ qdata,
                     int* __restrict__ qi) {
    __shared__ float s_planes[24], s_mvp[16], s_vp[16];
    __shared__ float4 s_stage[GROUPS_PER_BLOCK][2][QUAD_PMAX];
    const int t = threadIdx.x;
    if (t < 24) s_planes[t] = planes[t];
    if (t < 16) {
        s_mvp[t] = mvp[t];
        s_vp[t] = viewport[t];
    }
    __syncthreads();
    const int n = max(0, min(*n_rows, cap));

    // Rows [n, cap) as zeros, 16 bytes a store.
    const size_t tid = (size_t)blockIdx.x * PREP_THREADS + t;
    const size_t stride = (size_t)gridDim.x * PREP_THREADS;
    const size_t zd = (size_t)(cap - n) * (Q_COLS / 4);
    const size_t zi = (size_t)(cap - n) * (QI_COLS / 4);
    float4* zq = reinterpret_cast<float4*>(qdata + (size_t)n * Q_COLS);
    int4* zqi = reinterpret_cast<int4*>(qi + (size_t)n * QI_COLS);
    for (size_t k = tid; k < zd + zi; k += stride) {
        if (k < zd)
            zq[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        else
            zqi[k - zd] = make_int4(0, 0, 0, 0);
    }

    // Rows [0, n): a group per row, two per warp; the loop is uniform over
    // the warp (a group past n runs on the zero polygon and writes nothing).
    const int j = t % GROUP;
    const int half = (t / GROUP) % 2;
    const int shift = half * GROUP;
    float4(*stage)[QUAD_PMAX] = s_stage[t / GROUP];
    const int warp = (int)(tid / 32);
    const int n_warps = (int)(stride / 32);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int base = 2 * warp; base < n; base += 2 * n_warps) {
        const int i = base + half;
        const bool live = i < n;
        float4 v = zero;
        if (live && j < 4) {
            const float* src = quad + (size_t)order[i] * 16 + 4 * j;
            v = make_float4(src[0], src[1], src[2], src[3]);
        }
        int count = live ? 4 : 0;
#pragma unroll
        for (int k = 0; k < 6; ++k)
            count = clip_pass(v, count, s_planes + 4 * k, j, shift,
                              stage[k % 2]);

        // Project slot j: MVP, / w (all four components), viewport.
        const float4 ndc = rowvec(v, s_mvp);
        const float4 q = make_float4(
            __fdiv_rn(ndc.x, ndc.w), __fdiv_rn(ndc.y, ndc.w),
            __fdiv_rn(ndc.z, ndc.w), __fdiv_rn(ndc.w, ndc.w));
        const float4 scr = rowvec(q, s_vp);
        const float sx = scr.x, sy = scr.y;

        // pack_quads: the plane normal from the first three slots.
        const float s0x = __shfl_sync(FULL, sx, 0, GROUP);
        const float s0y = __shfl_sync(FULL, sy, 0, GROUP);
        const float s0z = __shfl_sync(FULL, scr.z, 0, GROUP);
        const float s1x = __shfl_sync(FULL, sx, 1, GROUP);
        const float s1y = __shfl_sync(FULL, sy, 1, GROUP);
        const float s1z = __shfl_sync(FULL, scr.z, 1, GROUP);
        const float s2x = __shfl_sync(FULL, sx, 2, GROUP);
        const float s2y = __shfl_sync(FULL, sy, 2, GROUP);
        const float s2z = __shfl_sync(FULL, scr.z, 2, GROUP);
        const float d1x = s0x - s1x, d1y = s0y - s1y, d1z = s0z - s1z;
        const float d2x = s0x - s2x, d2y = s0y - s2y, d2z = s0z - s2z;
        const float nx = d1y * d2z - d1z * d2y;
        const float ny = d1z * d2x - d1x * d2z;
        const float nz = d1x * d2y - d1y * d2x;
        const float d_coef = -((s0x * nx + s0y * ny) + s0z * nz);
        const bool is_front = nz < 0.0f;

        // The bbox over the active slots (a butterfly over the group).
        const bool active = j < QUAD_PMAX && j < count;
        float min_x = active ? sx : INFINITY, max_x = active ? sx : -INFINITY;
        float min_y = active ? sy : INFINITY, max_y = active ? sy : -INFINITY;
#pragma unroll
        for (int off = GROUP / 2; off > 0; off /= 2) {
            min_x = min_nan(min_x, __shfl_xor_sync(FULL, min_x, off, GROUP));
            max_x = max_nan(max_x, __shfl_xor_sync(FULL, max_x, off, GROUP));
            min_y = min_nan(min_y, __shfl_xor_sync(FULL, min_y, off, GROUP));
            max_y = max_nan(max_y, __shfl_xor_sync(FULL, max_y, off, GROUP));
        }
        // torch.clamp: NaN stays NaN.
        min_x = isnan(min_x) ? min_x : fmaxf(min_x, 0.0f);
        max_x = isnan(max_x) ? max_x : fminf(max_x, (float)width);
        min_y = isnan(min_y) ? min_y : fmaxf(min_y, 0.0f);
        max_y = isnan(max_y) ? max_y : fminf(max_y, (float)height);
        const bool box_valid = !((min_x > max_x) || (min_y > max_y));

        // quad_edge_coeffs over the nan_to_num'd screen x, y.
        const float x = nan_to_num(sx), y = nan_to_num(sy);
        const int nj = next_slot(j, count);
        const float px1 = __shfl_sync(FULL, x, nj, GROUP);
        const float py1 = __shfl_sync(FULL, y, nj, GROUP);
        if (!live) continue;
        float* qd = qdata + (size_t)i * Q_COLS;
        int* qq = qi + (size_t)i * QI_COLS;
        if (j < QUAD_PMAX) {
            const float fs = is_front ? 1.0f : -1.0f;
            float A = 0.0f, B = 0.0f, K = 1.0f;
            if (active) {
                A = (py1 - y) * fs;
                B = -(px1 - x) * fs;
                K = -(x * A + y * B);
            }
            qd[j] = A;
            qd[12 + j] = B;
            qd[24 + j] = K;
        }
        if (j < 8) {
            // Lane k < 4 the bbox's k-th bound (min_x, max_x, min_y,
            // max_y), ceiled, zero where not finite; selects, not an
            // indexed array, so nothing leaves the registers.
            const int k = j % 4;
            const float b = k == 0 ? min_x : k == 1 ? max_x
                                   : k == 2 ? min_y : max_y;
            const float c = ceilf(b);
            const int ib = isfinite(c) ? static_cast<int>(c) : 0;
            // Plane depth z_raw = zx*x + zy*y + zd (edge-on quads:
            // nz == 0).
            const float czs = nz == 0.0f ? 1.0f : nz;
            const float num = k == 0 ? -nx : k == 1 ? -ny : -d_coef;
            qd[36 + j] = j < 3 ? __fdiv_rn(num, czs)
                               : j == 3 ? 0.0f : static_cast<float>(ib);
            int word = ib;
            if (j == 4) word = count;
            if (j == 5) word = (count >= 3 && box_valid) ? 1 : 0;
            if (j == 6) word = is_front ? 1 : 0;
            if (j == 7) word = 0;
            qq[j] = word;
        }
    }
}

}  // namespace

// The persistent grid of quad_prep_kernel on the current device: SMs times
// its resident blocks per SM, into *blocks.
TR_EXPORT int tr_quad_prep_blocks(int* blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, quad_prep_kernel, PREP_THREADS, 0);
    *blocks = sms * per_sm;
    return (int)err;
}

// blocks: tr_quad_prep_blocks' grid; the rows follow *n_rows, not cap.
TR_EXPORT int tr_quad_prep(const float* quad, const int* order, int cap,
                           const int* n_rows, const float* planes,
                           const float* mvp, const float* viewport,
                           int height, int width, float* qdata, int* qi,
                           int blocks, void* stream) {
    quad_prep_kernel<<<blocks, PREP_THREADS, 0, (cudaStream_t)stream>>>(
        quad, order, cap, n_rows, planes, mvp, viewport, height, width,
        qdata, qi);
    return (int)cudaGetLastError();
}
