// K5 gbuffer_slim: the 3- or 11-channel G-buffer the flat, gouraud and pbr
// shaders read, for each pixel's winning face.
//
// Replaces tpu_renderer/ops/raster_pallas.py visibility_gbuffer_pallas,
// phase 1 with gb_layout in {"flat", "gouraud", "pbr"} (_slim_interp_face,
// raster_pallas.py:1294-1319, layouts _SLIM_CHANNELS :1275); gbuffer_pallas
// (:2776) computes the same against a given tid.
//
// Layouts (raster_cuda.SLIM_CHANNELS / pack_slim_attrs):
//   flat    (3 face columns -> 3 planes): the face normal, constant per face;
//   gouraud (9 -> 3): vertex normals interpolated with RAW screen
//           barycentrics u = 1 - v - w — no perspective correction, as the
//           reference's gouraud and pbr shaders use ``bar``;
//   pbr     (23 -> 11): that normal, interpolated (sx, sy, z_lin), Pm, Pr, Ka.
// Background pixels get zero, as the Pallas kernel's zero-filled blocks do.
// A triangle shard writes only the pixels its own faces won, ids in
// [gid0, gid0 + g_local), and zero elsewhere, rows from row0 in global
// coordinates (gbuffer_pallas; see gbuffer.cu).
//
// What bounds it on the H100: memory — 12 or 44 bytes written per pixel
// (12.6 or 46 MB at 1024^2) against at most ~60 flops; the face rows are
// gathered per pixel, and neighbouring pixels share faces, so they hit
// L1/L2. Design: one thread per pixel reads its winner's rows directly (no
// face loop, as K2); the layout is a template argument, so each variant
// keeps its channels in registers; stores are plane-major, so a warp writes
// 32 consecutive floats per channel. -fmad=false keeps it bit-identical to
// the plain version (raster_cuda.gbuffer_slim_plain).
#include "common.cuh"

namespace {

constexpr int SLIM_FLAT = 0;
constexpr int SLIM_GOURAUD = 1;
constexpr int SLIM_PBR = 2;

template <int LAYOUT>
__global__ void gbuffer_slim_kernel(const float* __restrict__ fdata,
                                    const float* __restrict__ sdata,
                                    const int* __restrict__ tid, int height,
                                    int width, int row0, int gid0,
                                    int g_local, float* __restrict__ gb) {
    constexpr int NCH = LAYOUT == SLIM_PBR ? 11 : 3;
    constexpr int SCOLS =
        LAYOUT == SLIM_FLAT ? 3 : (LAYOUT == SLIM_GOURAUD ? 9 : 23);
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const size_t plane = (size_t)height * width;
    const size_t p = (size_t)row * width + col;
    const int t = tid[p] - gid0;
    if (t < 0 || t >= g_local) {
        for (int ch = 0; ch < NCH; ++ch) gb[ch * plane + p] = 0.0f;
        return;
    }
    const float* s = sdata + (size_t)t * SCOLS;
    float out[NCH];
    if constexpr (LAYOUT == SLIM_FLAT) {
        for (int ci = 0; ci < 3; ++ci) out[ci] = s[ci];
    } else {
        const float* f = fdata + (size_t)t * F_COLS;
        const float r = static_cast<float>(row0 + row);
        const float c = static_cast<float>(col);
        const float v = f[0] * c + f[1] * r + f[2];
        const float w = f[3] * c + f[4] * r + f[5];
        const float u = 1.0f - v - w;
#define INTERP(c0, c1, c2) (u * (c0) + v * (c1) + w * (c2))
        for (int ci = 0; ci < 3; ++ci)
            out[ci] = INTERP(s[ci], s[3 + ci], s[6 + ci]);         // normal
        if constexpr (LAYOUT == SLIM_PBR) {
            for (int ci = 0; ci < 3; ++ci) {                        // sx sy zlin
                const int b = 9 + 3 * ci;
                out[3 + ci] = INTERP(s[b], s[b + 1], s[b + 2]);
            }
            out[6] = s[18];                                         // Pm
            out[7] = s[19];                                         // Pr
            for (int ci = 0; ci < 3; ++ci) out[8 + ci] = s[20 + ci];  // Ka
        }
#undef INTERP
    }
    for (int ch = 0; ch < NCH; ++ch) gb[ch * plane + p] = out[ch];
}

}  // namespace

TR_EXPORT int tr_gbuffer_slim(const float* fdata, const float* sdata,
                              const int* tid, int layout, int height,
                              int width, int row0, int gid0, int g_local,
                              float* gbuffer, void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    cudaStream_t st = (cudaStream_t)stream;
    switch (layout) {
        case SLIM_FLAT:
            gbuffer_slim_kernel<SLIM_FLAT><<<grid, block, 0, st>>>(
                fdata, sdata, tid, height, width, row0, gid0, g_local,
                gbuffer);
            break;
        case SLIM_GOURAUD:
            gbuffer_slim_kernel<SLIM_GOURAUD><<<grid, block, 0, st>>>(
                fdata, sdata, tid, height, width, row0, gid0, g_local,
                gbuffer);
            break;
        case SLIM_PBR:
            gbuffer_slim_kernel<SLIM_PBR><<<grid, block, 0, st>>>(
                fdata, sdata, tid, height, width, row0, gid0, g_local,
                gbuffer);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
