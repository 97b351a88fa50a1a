// K2 gbuffer: the 32-channel G-buffer of each pixel's winning face.
//
// Replaces tpu_renderer/ops/raster_pallas.py visibility_gbuffer_pallas,
// phase 1 with gb_layout="general" (_gb_interp_face, raster_pallas.py:
// 1322-1397); gbuffer_pallas computes the same against a given tid.
//
// For pixels with tid >= 0: perspective-corrected barycentrics from the
// affine coefficients and 1/w, then world position, uv, vertex normal,
// closed-form tangent/bitangent (adjugate of A = (b-a, c-a, n)), material
// constants, texture slots and shapes, tangent flag and model id —
// _gb_interp_face's expressions term for term. Background pixels get zero,
// as the Pallas kernel's zero-filled blocks do.
//
// Owned range (gbuffer_pallas, raster_pallas.py:2776): a triangle shard holds
// the faces with global ids [gid0, gid0 + g_local) and writes only the
// pixels whose merged tid lies in that range (face tid - gid0); every other
// pixel is zero, so the shards' partial buffers SUM to the whole one. Rows
// start at row0, in global pixel coordinates. One device: gid0 = 0,
// g_local = G, row0 = 0.
//
// What bounds it on the H100: memory — 128 bytes of output per pixel
// (32 MiB at 1024^2) against ~100 flops; the face rows (76 floats) are
// gathered per pixel but neighbouring pixels share faces, so they hit L1/L2.
// Design: one thread per pixel reads its winner directly — a GPU has no
// per-pixel gather penalty, so the TPU kernel's re-visit of every binned
// face is not needed. Stores are plane-major, so a warp writes 32
// consecutive floats per channel. -fmad=false and __fdiv_rn keep the
// results bit-identical to the plain version (raster_cuda.gbuffer_plain).
#include "common.cuh"

namespace {

__global__ void gbuffer_kernel(const float* __restrict__ fdata,
                               const float* __restrict__ adata,
                               const int* __restrict__ tid, int height,
                               int width, int row0, int gid0, int g_local,
                               float* __restrict__ gb) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const size_t plane = (size_t)height * width;
    const size_t p = (size_t)row * width + col;
    const int t = tid[p] - gid0;
    float out[GB_CHANNELS];
    if (t < 0 || t >= g_local) {
        for (int ch = 0; ch < GB_CHANNELS; ++ch) gb[ch * plane + p] = 0.0f;
        return;
    }
    const float* f = fdata + (size_t)t * F_COLS;
    const float* a = adata + (size_t)t * A_COLS;
    const float r = static_cast<float>(row0 + row);
    const float c = static_cast<float>(col);

    const float v = f[0] * c + f[1] * r + f[2];
    const float w = f[3] * c + f[4] * r + f[5];
    const float u = 1.0f - v - w;
    const float su = u * f[F_INV_W];
    const float sv = v * f[F_INV_W + 1];
    const float sw = w * f[F_INV_W + 2];
    const float inv_s = __fdiv_rn(1.0f, su + sv + sw);
    const float pb0 = su * inv_s, pb1 = sv * inv_s, pb2 = sw * inv_s;
#define INTERP(c0, c1, c2) (pb0 * (c0) + pb1 * (c1) + pb2 * (c2))

    float wx[9];
    for (int i = 0; i < 9; ++i) wx[i] = a[i];
    for (int ci = 0; ci < 3; ++ci)
        out[ci] = INTERP(wx[ci], wx[3 + ci], wx[6 + ci]);            // world
    const float u0 = a[9], u1 = a[10], u2 = a[11];
    const float v0 = a[12], v1 = a[13], v2 = a[14];
    out[3] = INTERP(u0, u1, u2);                                        // iu
    out[4] = INTERP(v0, v1, v2);                                        // iv
    float n[3];
    for (int ci = 0; ci < 3; ++ci) {
        n[ci] = INTERP(a[15 + ci], a[18 + ci], a[21 + ci]);            // normal
        out[5 + ci] = n[ci];
    }
#undef INTERP
    const float e1[3] = {wx[3] - wx[0], wx[4] - wx[1], wx[5] - wx[2]};
    const float e2[3] = {wx[6] - wx[0], wx[7] - wx[1], wx[8] - wx[2]};
    const float c0[3] = {e2[1] * n[2] - e2[2] * n[1],
                         e2[2] * n[0] - e2[0] * n[2],
                         e2[0] * n[1] - e2[1] * n[0]};
    const float c1[3] = {n[1] * e1[2] - n[2] * e1[1],
                         n[2] * e1[0] - n[0] * e1[2],
                         n[0] * e1[1] - n[1] * e1[0]};
    const float det = e1[0] * c0[0] + e1[1] * c0[1] + e1[2] * c0[2];
    const float inv_det = __fdiv_rn(1.0f, det);
    const float du0 = u1 - u0, du1 = u2 - u0;
    const float dv0 = v1 - v0, dv1 = v2 - v0;
    for (int ci = 0; ci < 3; ++ci) {
        out[8 + ci] = (c0[ci] * du0 + c1[ci] * du1) * inv_det;        // tangent
        out[11 + ci] = (c0[ci] * dv0 + c1[ci] * dv1) * inv_det;       // bitangent
    }
    for (int i = 0; i < 3; ++i) {
        out[14 + i] = a[24 + i];                                        // Kd
        out[17 + i] = a[27 + i];                                        // Ks
    }
    out[20] = a[30];                                                    // Ns
    for (int off = 0; off < 10; ++off) out[21 + off] = a[31 + off];    // slots
    out[31] = a[41];                                                    // model
    for (int ch = 0; ch < GB_CHANNELS; ++ch) gb[ch * plane + p] = out[ch];
}

}  // namespace

TR_EXPORT int tr_gbuffer(const float* fdata, const float* adata,
                         const int* tid, int height, int width, int row0,
                         int gid0, int g_local, float* gbuffer,
                         void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    gbuffer_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        fdata, adata, tid, height, width, row0, gid0, g_local, gbuffer);
    return (int)cudaGetLastError();
}
