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
// One thread per table row i < cap: for i < *n_rows it reads the extruded
// quad quad[order[i]] (4 vertices x 4 floats) and
// - clips it against the six frustum planes in Sutherland-Hodgman passes,
//   in ops/frustum._clip_one_plane's append order (per edge i of the
//   polygon: the current vertex if visible, then the intersection from
//   the next vertex toward the current one on a visibility change; a
//   segment with |denominator| < 1e-10 or a weight outside [0, 1] adds
//   none), into QUAD_PMAX slots whose count may run past them as the
//   plain version's does;
// - projects every slot: row vector times MVP, divided by w, times the
//   viewport (shadow.clip_project; the slots past the count are the zero
//   vertex, whose projection is NaN, as in the plain version);
// - packs the row as raster_cuda.pack_quads does (edge coefficients of
//   shadow.quad_edge_coeffs, the depth plane, the bbox clamped, ceiled
//   and zeroed where not finite, nan_to_num of the screen x and y to
//   +-3e38, box_valid, is_front; ok is count >= 3).
// Every row i >= *n_rows is written as zeros (inactive), so no row from an
// earlier frame or replay reaches K4, and the tables equal the plain
// version's over all cap rows.
//
// Bit-identity with the plain version (quad_prep_plain) comes from the
// library's -fmad=false, __fdiv_rn for every division the plain version
// makes (the clip weight, the divide by w, the depth plane), and sums in
// the plain version's left-to-right order. The reductions follow torch's
// NaN rules: amin/amax and clamp propagate NaN; the float-to-int cast
// saturates as torch's does on the card.
//
// What bounds it on the H100: neither bytes (68 B read and 208 B written
// per silhouette row) nor operations, but latency: a thread's clip loop is
// serial, over two 48-float polygons in local memory. At the crowd's 6,616
// silhouette rows that is 52 blocks of 128 threads, under half the card; a
// faster design (a warp per quad, or the polygon in shared memory) is
// later work.
#include "common.cuh"

namespace {

constexpr int QUAD_PMAX = 12;  // shadow.QUAD_PMAX
constexpr int PREP_THREADS = 128;

__device__ __forceinline__ float dot4(const float* a, const float* p) {
    return ((a[0] * p[0] + a[1] * p[1]) + a[2] * p[2]) + a[3] * p[3];
}

// One row vector times a row-major 4x4 matrix, summed left to right
// (vertex._rowvec).
__device__ __forceinline__ void rowvec(const float* v, const float* m,
                                       float* out) {
    for (int c = 0; c < 4; ++c)
        out[c] = ((v[0] * m[c] + v[1] * m[4 + c]) + v[2] * m[8 + c]) +
                 v[3] * m[12 + c];
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

// One Sutherland-Hodgman pass: `in` holds `count` active vertices (count
// may exceed QUAD_PMAX; the slots stop there), `out` receives the first
// QUAD_PMAX emitted vertices, zeros after them; returns the emitted count.
__device__ int clip_one_plane(float (*in)[4], int count,
                              const float* plane, float (*out)[4]) {
    for (int j = 0; j < QUAD_PMAX; ++j)
        for (int c = 0; c < 4; ++c) out[j][c] = 0.0f;
    int pos = 0;
    for (int i = 0; i < QUAD_PMAX && i < count; ++i) {
        const float* cur = in[i];
        const float* nxt = (i + 1 >= count || i + 1 == QUAD_PMAX)
                               ? in[0] : in[i + 1];
        const float dist_cur = dot4(cur, plane);
        const float dist_nxt = dot4(nxt, plane);
        const bool cur_vis = dist_cur >= 0.0f;
        const bool nxt_vis = dist_nxt >= 0.0f;
        if (cur_vis) {
            if (pos < QUAD_PMAX)
                for (int c = 0; c < 4; ++c) out[pos][c] = cur[c];
            ++pos;
        }
        if (cur_vis != nxt_vis) {
            float dir[4];
            for (int c = 0; c < 4; ++c) dir[c] = cur[c] - nxt[c];
            const float denom = dot4(dir, plane);
            const bool parallel = fabsf(denom) < 1e-10f;
            const float weight =
                __fdiv_rn(-dist_nxt, parallel ? 1.0f : denom);
            if (!parallel && weight >= 0.0f && weight <= 1.0f) {
                if (pos < QUAD_PMAX)
                    for (int c = 0; c < 4; ++c)
                        out[pos][c] = nxt[c] + weight * dir[c];
                ++pos;
            }
        }
    }
    return pos;
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
    const int i = blockIdx.x * PREP_THREADS + threadIdx.x;
    if (i >= cap) return;
    float* qd = qdata + (size_t)i * Q_COLS;
    int* qq = qi + (size_t)i * QI_COLS;
    if (i >= *n_rows) {
        for (int k = 0; k < Q_COLS; ++k) qd[k] = 0.0f;
        for (int k = 0; k < QI_COLS; ++k) qq[k] = 0;
        return;
    }

    float a[QUAD_PMAX][4], b[QUAD_PMAX][4];
    const float* src = quad + (size_t)order[i] * 16;
    for (int j = 0; j < QUAD_PMAX; ++j)
        for (int c = 0; c < 4; ++c) a[j][c] = j < 4 ? src[4 * j + c] : 0.0f;
    int count = 4;
    // Six passes, ping-ponging between a and b: the result is back in a.
    for (int k = 0; k < 6; k += 2) {
        count = clip_one_plane(a, count, planes + 4 * k, b);
        count = clip_one_plane(b, count, planes + 4 * (k + 1), a);
    }

    // Project every slot: MVP, / w (all four components), viewport.
    float sx[QUAD_PMAX], sy[QUAD_PMAX], s0z = 0.0f, s1z = 0.0f, s2z = 0.0f;
    for (int j = 0; j < QUAD_PMAX; ++j) {
        float ndc[4], q[4], scr[4];
        rowvec(a[j], mvp, ndc);
        for (int c = 0; c < 4; ++c) q[c] = __fdiv_rn(ndc[c], ndc[3]);
        rowvec(q, viewport, scr);
        sx[j] = scr[0];
        sy[j] = scr[1];
        if (j == 0) s0z = scr[2];
        if (j == 1) s1z = scr[2];
        if (j == 2) s2z = scr[2];
    }

    // pack_quads: the plane normal from the first three slots.
    const float d1x = sx[0] - sx[1], d1y = sy[0] - sy[1], d1z = s0z - s1z;
    const float d2x = sx[0] - sx[2], d2y = sy[0] - sy[2], d2z = s0z - s2z;
    const float nx = d1y * d2z - d1z * d2y;
    const float ny = d1z * d2x - d1x * d2z;
    const float nz = d1x * d2y - d1y * d2x;
    const float d_coef = -((sx[0] * nx + sy[0] * ny) + s0z * nz);
    const bool is_front = nz < 0.0f;

    float min_x = INFINITY, max_x = -INFINITY;
    float min_y = INFINITY, max_y = -INFINITY;
    for (int j = 0; j < QUAD_PMAX && j < count; ++j) {
        min_x = min_nan(min_x, sx[j]);
        max_x = max_nan(max_x, sx[j]);
        min_y = min_nan(min_y, sy[j]);
        max_y = max_nan(max_y, sy[j]);
    }
    // torch.clamp: NaN stays NaN.
    min_x = isnan(min_x) ? min_x : fmaxf(min_x, 0.0f);
    max_x = isnan(max_x) ? max_x : fminf(max_x, (float)width);
    min_y = isnan(min_y) ? min_y : fmaxf(min_y, 0.0f);
    max_y = isnan(max_y) ? max_y : fminf(max_y, (float)height);
    const bool box_valid = !((min_x > max_x) || (min_y > max_y));
    const float box[4] = {min_x, max_x, min_y, max_y};
    int bbox[4];
    for (int k = 0; k < 4; ++k) {
        const float c = ceilf(box[k]);
        bbox[k] = isfinite(c) ? static_cast<int>(c) : 0;
    }

    // quad_edge_coeffs over the nan_to_num'd screen x, y.
    const float fs = is_front ? 1.0f : -1.0f;
    for (int j = 0; j < QUAD_PMAX; ++j) {
        float A = 0.0f, B = 0.0f, K = 1.0f;
        if (j < count) {
            const int nj = (j + 1 >= count || j + 1 == QUAD_PMAX) ? 0 : j + 1;
            const float x = nan_to_num(sx[j]), y = nan_to_num(sy[j]);
            const float px1 = nan_to_num(sx[nj]), py1 = nan_to_num(sy[nj]);
            A = (py1 - y) * fs;
            B = -(px1 - x) * fs;
            K = -(x * A + y * B);
        }
        qd[j] = A;
        qd[12 + j] = B;
        qd[24 + j] = K;
    }
    // Plane depth z_raw = zx*x + zy*y + zd (edge-on quads: nz == 0).
    const float czs = nz == 0.0f ? 1.0f : nz;
    qd[36] = __fdiv_rn(-nx, czs);
    qd[37] = __fdiv_rn(-ny, czs);
    qd[38] = __fdiv_rn(-d_coef, czs);
    qd[39] = 0.0f;
    for (int k = 0; k < 4; ++k) {
        qd[40 + k] = static_cast<float>(bbox[k]);
        qq[k] = bbox[k];
    }
    qq[4] = count;
    qq[5] = (count >= 3 && box_valid) ? 1 : 0;
    qq[6] = is_front ? 1 : 0;
    qq[7] = 0;
}

}  // namespace

TR_EXPORT int tr_quad_prep(const float* quad, const int* order, int cap,
                           const int* n_rows, const float* planes,
                           const float* mvp, const float* viewport,
                           int height, int width, float* qdata, int* qi,
                           void* stream) {
    const int blocks = (cap + PREP_THREADS - 1) / PREP_THREADS;
    if (blocks > 0)
        quad_prep_kernel<<<blocks, PREP_THREADS, 0, (cudaStream_t)stream>>>(
            quad, order, cap, n_rows, planes, mvp, viewport, height, width,
            qdata, qi);
    return (int)cudaGetLastError();
}
