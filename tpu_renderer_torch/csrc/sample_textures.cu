// K3 sample_textures: nearest-texel texture samples of each winning pixel.
//
// Replaces the in-kernel windowed texture sampler of tpu_renderer/ops/
// raster_pallas.py (_sample_face_slab :1886, _sample_half :1952, inside
// visibility_gbuffer_pallas; standalone form sample_textures_pallas :2262).
//
// For each pixel with tid >= 0 and each texture kind k (kd, norm, ks) whose
// face has a map: col = clip(iu, max=1)*(TW-1), row = (1-clip(iv, max=1))*
// (TH-1), truncated, then floor-mod wrapped like pipeline._wrap_index (C's %
// truncates toward zero, so the wrap is i - dim*floor(i/dim) in float), then
// clamped into the texture (no read can leave it; NaN lands on 0). The
// packed RGB texel lands in samp[k] and bit k in mask; other entries are 0.
// A triangle shard samples only the pixels its own faces won, ids in
// [gid0, gid0 + g_local) (ftex holds its faces' rows), so the shards'
// partial samp and mask planes SUM to the whole ones
// (sample_textures_pallas :2262, standalone form). One device: gid0 = 0,
// g_local = G.
//
// What bounds it on the H100: the texel gathers — up to three random 4-byte
// reads per pixel from a pool of a few tens of MiB, which sits in the 50 MB
// L2 — plus the 16 bytes per pixel of output. Design: one thread per pixel
// gathers straight from the scene-wide pool through a per-slot (offset, row
// stride) table, so the TPU's texel windows, window grids and speculative
// DMA have no counterpart here. -fmad=false and __fdiv_rn keep the indices
// bit-identical to the plain version (raster_cuda.sample_textures_plain).
#include "common.cuh"

namespace {

// pipeline._wrap_index then the clamp into [0, dim - 1].
__device__ __forceinline__ int wrap_clamped(float x, float dim) {
    const float i = truncf(x);
    float wrapped = i - dim * floorf(__fdiv_rn(i, dim));
    wrapped = (wrapped >= 0.0f) ? wrapped : 0.0f;
    wrapped = (wrapped <= dim - 1.0f) ? wrapped : dim - 1.0f;
    return static_cast<int>(wrapped);
}

__global__ void sample_kernel(const int* __restrict__ tid,
                              const float* __restrict__ iu_plane,
                              const float* __restrict__ iv_plane,
                              const int* __restrict__ ftex,
                              const int* __restrict__ slots,
                              const int* __restrict__ pool, int n_kinds,
                              int n_slots, int pool_size, int height,
                              int width, int gid0, int g_local,
                              int* __restrict__ samp,
                              int* __restrict__ mask_out) {
    const int row = blockIdx.y * TILE + threadIdx.y;
    const int col = blockIdx.x * TILE + threadIdx.x;
    if (row >= height || col >= width) return;
    const size_t plane = (size_t)height * width;
    const size_t p = (size_t)row * width + col;
    const int t = tid[p] - gid0;
    const bool owned = t >= 0 && t < g_local;
    int mask = 0;
    const float iu = iu_plane[p], iv = iv_plane[p];
    // torch.clamp(max=1) semantics: NaN stays NaN.
    const float ciu = (iu > 1.0f) ? 1.0f : iu;
    const float civ = (iv > 1.0f) ? 1.0f : iv;
    for (int k = 0; k < n_kinds; ++k) {
        int texel = 0;
        if (owned) {
            const int* ft = ftex + ((size_t)t * n_kinds + k) * 3;
            const int slot = ft[0];
            if (slot >= 0 && slot < n_slots) {
                const float th = static_cast<float>(ft[1]);
                const float tw = static_cast<float>(ft[2]);
                const int ic = wrap_clamped(ciu * (tw - 1.0f), tw);
                const int ir = wrap_clamped((1.0f - civ) * (th - 1.0f), th);
                const long long idx = (long long)slots[2 * slot] +
                                      (long long)ir * slots[2 * slot + 1] + ic;
                if (idx >= 0 && idx < pool_size) {
                    texel = pool[idx];
                    mask |= 1 << k;
                }
            }
        }
        samp[k * plane + p] = texel;
    }
    mask_out[p] = mask;
}

}  // namespace

TR_EXPORT int tr_sample_textures(const int* tid, const float* iu,
                                 const float* iv, const int* ftex,
                                 const int* slots, const int* pool,
                                 int n_kinds, int n_slots,
                                 int pool_size, int height, int width,
                                 int gid0, int g_local, int* samp, int* mask,
                                 void* stream) {
    const dim3 block(TILE, TILE);
    const dim3 grid((width + TILE - 1) / TILE, (height + TILE - 1) / TILE);
    sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        tid, iu, iv, ftex, slots, pool, n_kinds, n_slots, pool_size, height,
        width, gid0, g_local, samp, mask);
    return (int)cudaGetLastError();
}
