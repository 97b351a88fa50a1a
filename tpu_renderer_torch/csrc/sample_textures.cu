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
// A slot past the slot table or an index past the pool samples nothing.
// A triangle shard samples only the pixels its own faces won, ids in
// [gid0, gid0 + g_local) (ftex holds its faces' rows), so the shards'
// partial samp and mask planes SUM to the whole ones
// (sample_textures_pallas :2262, standalone form). One device: gid0 = 0,
// g_local = G.
//
// What it must move: every pixel reads its tid and writes n_kinds + 1
// words; iu and iv matter only where a pixel samples, the face rows and
// texels only where it wins. Design: the H*W pixels are one flat
// range, PX = 4 consecutive pixels a thread, so a warp reads and writes
// 512 contiguous bytes of each plane in 16-byte accesses (rows and tiles
// play no part: the result depends on the flat index alone). iu and iv are
// read only when one of the thread's pixels is owned, so background and
// other shards' pixels cost their tid and their zero outputs. Per kind, the
// face's texture row and slot are loaded once per run of one face along
// the thread's pixels. Tables and texels go through the read-only path;
// the per-pixel planes are read and written with the evict-first hint, so
// that at 2048^2 and 4096^2 they do not push the texel pool out of L2.
// Where a plane is not 16-byte aligned (H*W not a multiple of 4, and iu/iv
// planes of the G-buffer at k*H*W words), the launcher takes the scalar
// instance of the same kernel, which does every access 4 bytes at a time;
// both instances handle the last H*W mod 4 pixels scalar. What bounds it
// on the H100: at 2048^2 and up those bytes; at 1024^2 the grid is about
// one wave, and the sampled pixels' dependent loads (tid, iu/iv, face row,
// slot, texel) add to the stream of zeros the rest write (PERF.md section
// 6). -fmad=false and __fdiv_rn keep the indices bit-identical to the plain
// version (raster_cuda.sample_textures_plain).
#include "common.cuh"

namespace {

// Pixels a thread handles, and threads a block.
constexpr int PX = 4;
constexpr int K3_THREADS = 256;

// pipeline._wrap_index then the clamp into [0, dim - 1].
__device__ __forceinline__ int wrap_clamped(float x, float dim) {
    const float i = truncf(x);
    float wrapped = i - dim * floorf(__fdiv_rn(i, dim));
    wrapped = (wrapped >= 0.0f) ? wrapped : 0.0f;
    wrapped = (wrapped <= dim - 1.0f) ? wrapped : dim - 1.0f;
    return static_cast<int>(wrapped);
}

// The n (1-4) words of a plane from p, read once: one 16-byte load where
// the instance is vectorized and all four are there.
template <bool kVec, typename T, typename T4>
__device__ __forceinline__ void load_px(const T* p, int n, T (&v)[PX]) {
    if (kVec && n == PX) {
        const T4 q = __ldcs(reinterpret_cast<const T4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
        return;
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
        v[j] = T(0);
        if (j < n) v[j] = __ldcs(p + j);
    }
}

// Store n (1-4) words to a plane from p, evict-first.
template <bool kVec>
__device__ __forceinline__ void store_px(int* p, int n, const int (&v)[PX]) {
    if (kVec && n == PX) {
        __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
        return;
    }
#pragma unroll
    for (int j = 0; j < PX; ++j)
        if (j < n) __stcs(p + j, v[j]);
}

template <bool kVec>
__global__ void __launch_bounds__(K3_THREADS)
    sample_kernel(const int* __restrict__ tid,
                  const float* __restrict__ iu_plane,
                  const float* __restrict__ iv_plane,
                  const int* __restrict__ ftex, const int* __restrict__ slots,
                  const int* __restrict__ pool, int n_kinds, int n_slots,
                  int pool_size, long long n_pix, int gid0, int g_local,
                  int* __restrict__ samp, int* __restrict__ mask_out) {
    const long long p =
        ((long long)blockIdx.x * K3_THREADS + threadIdx.x) * PX;
    if (p >= n_pix) return;
    const int n = (int)min((long long)PX, n_pix - p);
    const bool vec = kVec && n == PX;

    int t[PX];
    load_px<kVec, int, int4>(tid + p, n, t);
    bool own[PX];
    bool any = false;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
        // No overflow: t - gid0 is taken only where t >= gid0 >= 0.
        own[j] = j < n && t[j] >= gid0 && t[j] - gid0 < g_local;
        t[j] = own[j] ? t[j] - gid0 : -1;
        any |= own[j];
    }

    // torch.clamp(max=1) semantics: NaN stays NaN.
    float ciu[PX], civ[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) ciu[j] = civ[j] = 0.0f;
    if (vec && any) {
        load_px<true, float, float4>(iu_plane + p, n, ciu);
        load_px<true, float, float4>(iv_plane + p, n, civ);
    } else if (any) {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
            if (!own[j]) continue;
            ciu[j] = __ldcs(iu_plane + p + j);
            civ[j] = __ldcs(iv_plane + p + j);
        }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
        ciu[j] = (ciu[j] > 1.0f) ? 1.0f : ciu[j];
        civ[j] = (civ[j] > 1.0f) ? 1.0f : civ[j];
    }

    int mask[PX] = {0, 0, 0, 0};
    for (int k = 0; k < n_kinds; ++k) {
        int texel[PX];
        // The local face whose kind-k row is held, and that row.
        int face = -1, stride = 0;
        long long offset = 0;
        float th = 0.0f, tw = 0.0f;
        bool mapped = false;
#pragma unroll
        for (int j = 0; j < PX; ++j) {
            texel[j] = 0;
            if (!own[j]) continue;
            if (t[j] != face) {
                face = t[j];
                const int* ft = ftex + ((long long)face * n_kinds + k) * 3;
                const int slot = __ldg(ft);
                th = static_cast<float>(__ldg(ft + 1));
                tw = static_cast<float>(__ldg(ft + 2));
                mapped = slot >= 0 && slot < n_slots;
                if (mapped) {
                    offset = __ldg(slots + 2LL * slot);
                    stride = __ldg(slots + 2LL * slot + 1);
                }
            }
            if (!mapped) continue;
            const int ic = wrap_clamped(ciu[j] * (tw - 1.0f), tw);
            const int ir = wrap_clamped((1.0f - civ[j]) * (th - 1.0f), th);
            const long long idx = offset + (long long)ir * stride + ic;
            if (idx >= 0 && idx < pool_size) {
                texel[j] = __ldg(pool + idx);
                mask[j] |= 1 << k;
            }
        }
        store_px<kVec>(samp + (long long)k * n_pix + p, n, texel);
    }
    store_px<kVec>(mask_out + p, n, mask);
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

TR_EXPORT int tr_sample_textures(const int* tid, const float* iu,
                                 const float* iv, const int* ftex,
                                 const int* slots, const int* pool,
                                 int n_kinds, int n_slots,
                                 int pool_size, int height, int width,
                                 int gid0, int g_local, int* samp, int* mask,
                                 void* stream) {
    const long long n_pix = (long long)height * width;
    if (n_pix == 0) return (int)cudaSuccess;
    // 16-byte accesses where every plane allows them: samp's plane k
    // starts k*H*W words in.
    bool vec = aligned16(tid) && aligned16(iu) && aligned16(iv) &&
               aligned16(mask);
    for (int k = 0; k < n_kinds; ++k) vec = vec && aligned16(samp + k * n_pix);
    const long long groups = (n_pix + PX - 1) / PX;
    const unsigned blocks = (unsigned)((groups + K3_THREADS - 1) / K3_THREADS);
    if (vec)
        sample_kernel<true><<<blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
            tid, iu, iv, ftex, slots, pool, n_kinds, n_slots, pool_size,
            n_pix, gid0, g_local, samp, mask);
    else
        sample_kernel<false><<<blocks, K3_THREADS, 0, (cudaStream_t)stream>>>(
            tid, iu, iv, ftex, slots, pool, n_kinds, n_slots, pool_size,
            n_pix, gid0, g_local, samp, mask);
    return (int)cudaGetLastError();
}
