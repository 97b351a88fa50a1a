// K9 shade: the general shader's deferred shading of a whole frame, in one
// launch whatever the number of models.
//
// Replaces no pallas_call site: the JAX package shades the G-buffer with
// XLA (tpu_renderer/ops/pipeline.py:388, _shade_gbuffer, then
// ops/shading.py shade_general). Its plain version is
// raster_cuda.shade_plain, which the port ran op by op before: per model and
// texture kind a pass of full-frame PyTorch kernels, then about forty more
// for the Blinn-Phong terms.
//
// Per pixel (tid >= 0): the colour is Kd, or the diffuse map's sample; the
// normal is the normalized interpolated normal, or the normal map's sample
// (through the tangent basis where the face's map is a tangent-space one)
// normalized; the specular light is Ks * 255, or the specular map's red
// channel * 255. A kind's sample is used where K3 set its bit in samp_mask
// (K3 samples a kind only for faces whose model has that map) and the
// pixel's model id (GB_MODEL) names a row of the model table `scale_off`,
// which holds each model's (scale, offset) per kind: the texel's 8-bit
// channels * (1/255) * scale + offset. Instances of one mesh carry equal
// rows. Then shade.shade_general: attenuation from the distance to the
// light, the light direction (per pixel, or the light's own for a
// directional light), the spot cone, ambient, diffuse (unclamped) and
// specular terms, the shadowed pixels' ambient-only result, each clamped
// to [0.05, 1]. Background pixels (tid < 0) take the background: a colour,
// or the skybox's per-pixel plane (cubemap.fill_skybox).
//
// Arithmetic: every product, sum, quotient and square root is written with
// the round-to-nearest intrinsics, so none is contracted and none depends on
// the compiler's flags, in the plain version's order on the card: a sum over
// the last axis of three as PyTorch's reduction kernel takes it for these
// layouts, one accumulator per term, added in order, then its fourth, empty
// accumulator (+0); a quotient by a Python scalar as PyTorch's kernel does
// it on the card, times the scalar's float32 reciprocal; 1/x as
// reciprocal(x) * 1.0; the specular power by powf, as torch.pow.
//
// What it must move: every pixel reads its tid and writes its three
// floats; a foreground pixel reads the 14 G-buffer planes the shader reads
// (world, normal, Kd, Ks, Ns, model), the stencil with shadows, and the
// samples and mask where the scene has maps; the tangent, bitangent and
// tangent flag only where the normal map's bit is set; a background pixel
// the skybox plane over a cubemap. It is bound by those bytes (about 100 a
// foreground pixel): the arithmetic, some 150 float operations a pixel, is
// far below the card's rate. Design: the frame is one flat range, PX = 4
// consecutive pixels a thread, so a warp reads 512 contiguous bytes of each
// plane in 16-byte accesses and writes its 48 floats of the frame in three
// 16-byte streaming stores; a plane is read only where one of the thread's
// pixels needs it; the light and the model table go through the read-only
// path. The light type, shadows and the background kind are template
// arguments, so one compiled instance serves each kind of frame with no
// branch on them per pixel; the grid follows the frame's size alone, so a
// captured graph keeps it. Where a plane is not 16-byte aligned (H*W not a
// multiple of 4), the scalar instance takes one pixel a thread, 4 bytes an
// access.
#include "common.cuh"

namespace {

constexpr int PX = 4;
constexpr int K9_THREADS = 256;

// G-buffer channels (raster_cuda.GB_*).
constexpr int GB_WORLD = 0;
constexpr int GB_N = 5;
constexpr int GB_TAN = 8;
constexpr int GB_BIT = 11;
constexpr int GB_KD = 14;
constexpr int GB_KS = 17;
constexpr int GB_NS = 20;
constexpr int GB_TANGENT = 27;   // the normal map's tangent-space flag
constexpr int GB_MODEL = 31;
// Texture kinds, in sample-plane and mask-bit order (raster_cuda.KINDS).
constexpr int KIND_KD = 0;
constexpr int KIND_NORM = 1;
constexpr int KIND_KS = 2;
constexpr int N_KINDS = 3;

// The light table (raster_cuda._light_table).
constexpr int L_POS = 0;
constexpr int L_DIR = 3;
constexpr int L_COLOR = 6;
constexpr int L_AMBIENT = 9;
constexpr int L_SPECULAR = 12;
constexpr int L_CONSTANT = 13;
constexpr int L_LINEAR = 14;
constexpr int L_QUADRATIC = 15;
constexpr int L_CAMERA = 16;

// ops.lightning.Lightning values.
constexpr int DIRECTIONAL = 0;
constexpr int POINT = 1;
constexpr int SPOT = 2;

// 1/255 as PyTorch's kernel multiplies by it (x / 255.0 on the card).
constexpr float INV255 = 1.0f / 255.0f;

// Products and sums rounded one by one, whatever the compiler's flags.
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}

// torch.clamp(v, lo, hi) and torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

// The sum over the last axis of three of a channels-first (H, W, 3) view,
// as PyTorch's reduction kernel takes it: one accumulator per term, added
// in order, then the empty fourth (+0).
__device__ __forceinline__ float sum3(float a, float b, float c) {
    return add(add(add(a, b), c), 0.0f);
}
__device__ __forceinline__ float dot3(const float (&a)[3],
                                      const float (&b)[3]) {
    return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}
// transforms.normalize: divide by the L2 norm, a zero norm taken as 1.
__device__ __forceinline__ float norm3(const float (&a)[3]) {
    const float l2 = __fsqrt_rn(dot3(a, a));
    return l2 == 0.0f ? 1.0f : l2;
}
__device__ __forceinline__ void divide3(float (&a)[3], float l2) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = __fdiv_rn(a[c], l2);
}
__device__ __forceinline__ void normalize3(float (&a)[3]) {
    divide3(a, norm3(a));
}

// pipeline._unpack_texel's channel c: the packed texel's 8 bits, / 255,
// then the kind's (scale, offset).
__device__ __forceinline__ float texel(int packed, int c, float scale,
                                      float offset) {
    const float v = static_cast<float>((packed >> (8 * c)) & 0xFF);
    return add(mul(mul(v, INV255), scale), offset);
}

// P consecutive words of a plane from p: one 16-byte load for 4.
template <int P, typename T, typename T4>
__device__ __forceinline__ void load_px(const T* p, T (&v)[P]) {
    if constexpr (P == 4) {
        const T4 q = __ldcs(reinterpret_cast<const T4*>(p));
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
    } else {
#pragma unroll
        for (int j = 0; j < P; ++j) v[j] = __ldcs(p + j);
    }
}

// Three consecutive planes from channel c0 of the G-buffer.
template <int P>
__device__ __forceinline__ void load_vec(const float* gb, int c0,
                                         long long n_pix, long long p,
                                         float (&v)[3][P]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
        load_px<P, float, float4>(gb + (c0 + c) * n_pix + p, v[c]);
}

// The deferred general shading of one foreground pixel
// (shading.shade_general), from its colour, unit normal, world position,
// specular light and exponent; writes rgb.
template <int kLight, bool kShadows>
__device__ __forceinline__ void shade_general(
    const float* __restrict__ light, float spot_edge0, float spot_scale,
    float (&color)[3], const float (&normal)[3], const float (&frag)[3],
    const float (&spec_light)[3], float ns, bool shadowed,
    float (&rgb)[3]) {
    float lc[3], amb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        lc[c] = __ldg(light + L_COLOR + c);
        amb[c] = __ldg(light + L_AMBIENT + c);
    }
    float to_light[3], view[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        to_light[c] = sub(__ldg(light + L_POS + c), frag[c]);
        view[c] = sub(__ldg(light + L_CAMERA + c), frag[c]);
    }
    // The distance is normalize's norm of the same vector before its
    // zero test.
    const float distance = __fsqrt_rn(dot3(to_light, to_light));
    const float att = __fdiv_rn(
        1.0f, add(__ldg(light + L_CONSTANT),
                  mul(distance, add(__ldg(light + L_LINEAR),
                                    mul(__ldg(light + L_QUADRATIC),
                                        distance)))));
    float ambient_rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        ambient_rgb[c] = clamp(mul(mul(att, amb[c]), color[c]), 0.05f, 1.0f);

    float light_dir[3];
    if (kLight == DIRECTIONAL) {
#pragma unroll
        for (int c = 0; c < 3; ++c) light_dir[c] = __ldg(light + L_DIR + c);
    } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) light_dir[c] = to_light[c];
        divide3(light_dir, distance == 0.0f ? 1.0f : distance);
    }
    normalize3(view);
    if (kLight == SPOT) {
        float axis[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) axis[c] = __ldg(light + L_DIR + c);
        // smoothstep(cos 20°, cos 10°, axis · light_dir).
        const float t = clamp(
            mul(sub(dot3(axis, light_dir), spot_edge0), spot_scale), 0.0f,
            1.0f);
        const float in_light = mul(mul(t, t), sub(3.0f, mul(2.0f, t)));
#pragma unroll
        for (int c = 0; c < 3; ++c) color[c] = mul(color[c], in_light);
    }
    float halfway[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) halfway[c] = add(light_dir[c], view[c]);
    normalize3(halfway);
    const float spec_reflection =
        powf(clamp_min(dot3(normal, halfway), 0.0f), ns);
    const float strength = __ldg(light + L_SPECULAR);
    const float intensity = dot3(normal, light_dir);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float specular =
            mul(mul(mul(lc[c], spec_reflection), strength), spec_light[c]);
        const float diffuse = mul(intensity, lc[c]);
        const float lit = clamp(
            mul(mul(att, color[c]), add(add(amb[c], diffuse), specular)),
            0.05f, 1.0f);
        rgb[c] = (kShadows && shadowed) ? ambient_rgb[c] : lit;
    }
}

// kVec: 4 pixels a thread in 16-byte accesses (H*W a multiple of 4, every
// plane aligned); else one pixel a thread in 4-byte ones.
template <bool kVec, int kLight, bool kShadows, bool kSkyPlane>
__global__ void __launch_bounds__(K9_THREADS)
    shade_kernel(const int* __restrict__ tid, const int* __restrict__ stencil,
                 const float* __restrict__ gb, const int* __restrict__ samp,
                 const int* __restrict__ samp_mask,
                 const float* __restrict__ scale_off, int n_models,
                 const float* __restrict__ light,
                 const float* __restrict__ background, float spot_edge0,
                 float spot_scale, long long n_pix, float* __restrict__ out) {
    constexpr int P = kVec ? PX : 1;
    const long long p =
        ((long long)blockIdx.x * K9_THREADS + threadIdx.x) * P;
    if (p >= n_pix) return;

    int t[P];
    load_px<P, int, int4>(tid + p, t);
    bool fg[P];
    bool any_fg = false, any_bg = false;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        fg[j] = t[j] >= 0;
        any_fg |= fg[j];
        any_bg |= !fg[j];
    }

    float rgb[P][3];
    if (any_bg) {
        if (kSkyPlane) {
            float bg[3 * P];
            if constexpr (P == 4) {
#pragma unroll
                for (int q = 0; q < 3; ++q) {
                    const float4 v = __ldcs(
                        reinterpret_cast<const float4*>(background + 3 * p) +
                        q);
                    bg[4 * q] = v.x;
                    bg[4 * q + 1] = v.y;
                    bg[4 * q + 2] = v.z;
                    bg[4 * q + 3] = v.w;
                }
            } else {
#pragma unroll
                for (int i = 0; i < 3 * P; ++i)
                    bg[i] = __ldcs(background + 3 * p + i);
            }
#pragma unroll
            for (int j = 0; j < P; ++j)
#pragma unroll
                for (int c = 0; c < 3; ++c) rgb[j][c] = bg[3 * j + c];
        } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float b = __ldg(background + c);
#pragma unroll
                for (int j = 0; j < P; ++j) rgb[j][c] = b;
            }
        }
    }

    if (any_fg) {
        float world[3][P], nrm[3][P], kd[3][P], ks[3][P], ns[P], model[P];
        load_vec<P>(gb, GB_WORLD, n_pix, p, world);
        load_vec<P>(gb, GB_N, n_pix, p, nrm);
        load_vec<P>(gb, GB_KD, n_pix, p, kd);
        load_vec<P>(gb, GB_KS, n_pix, p, ks);
        load_px<P, float, float4>(gb + GB_NS * n_pix + p, ns);
        int st[P] = {};
        if (kShadows) load_px<P, int, int4>(stencil + p, st);

        // Which kinds each pixel takes from its samples, and its model's
        // row of the table.
        int bits[P] = {};
        int row[P] = {};
        int any_bits = 0;
        if (samp != nullptr) {
            load_px<P, int, int4>(samp_mask + p, bits);
            load_px<P, float, float4>(gb + GB_MODEL * n_pix + p, model);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                // A model id that is not one of the table's rows takes no
                // sample (the plain version's test, NaN included).
                const int m = __float2int_rz(model[j]);
                const bool known = m >= 0 && m < n_models &&
                                   __int2float_rn(m) == model[j];
                bits[j] = (fg[j] && known) ? bits[j] : 0;
                row[j] = known ? m : 0;
                any_bits |= bits[j];
            }
        }
        int sk[N_KINDS][P] = {};
#pragma unroll
        for (int k = 0; k < N_KINDS; ++k)
            if (any_bits & (1 << k))
                load_px<P, int, int4>(samp + k * n_pix + p, sk[k]);
        // The tangent basis only where a pixel takes its normal map's
        // sample.
        float tan[3][P], bit[3][P], tangent[P];
        if (any_bits & (1 << KIND_NORM)) {
            load_vec<P>(gb, GB_TAN, n_pix, p, tan);
            load_vec<P>(gb, GB_BIT, n_pix, p, bit);
            load_px<P, float, float4>(gb + GB_TANGENT * n_pix + p, tangent);
        }

#pragma unroll
        for (int j = 0; j < P; ++j) {
            if (!fg[j]) continue;
            const float* so = scale_off + (long long)row[j] * N_KINDS * 2;
            float color[3], normal[3], spec_light[3], frag[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                frag[c] = world[c][j];
                color[c] = kd[c][j];
                normal[c] = nrm[c][j];
                spec_light[c] = mul(ks[c][j], 255.0f);
            }
            if (bits[j] & (1 << KIND_KD)) {
                const float s = __ldg(so + 2 * KIND_KD);
                const float o = __ldg(so + 2 * KIND_KD + 1);
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    color[c] = texel(sk[KIND_KD][j], c, s, o);
            }
            normalize3(normal);
            if (bits[j] & (1 << KIND_NORM)) {
                const float s = __ldg(so + 2 * KIND_NORM);
                const float o = __ldg(so + 2 * KIND_NORM + 1);
                float smp[3], mapped[3];
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    smp[c] = texel(sk[KIND_NORM][j], c, s, o);
                if (tangent[j] > 0.5f) {
                    float tv[3], bv[3];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        tv[c] = tan[c][j];
                        bv[c] = bit[c][j];
                    }
                    normalize3(tv);
                    normalize3(bv);
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        mapped[c] = add(add(mul(tv[c], smp[0]),
                                            mul(bv[c], smp[1])),
                                        mul(normal[c], smp[2]));
                } else {
#pragma unroll
                    for (int c = 0; c < 3; ++c) mapped[c] = smp[c];
                }
                normalize3(mapped);
#pragma unroll
                for (int c = 0; c < 3; ++c) normal[c] = mapped[c];
            }
            if (bits[j] & (1 << KIND_KS)) {
                const float r = mul(texel(sk[KIND_KS][j], 0,
                                          __ldg(so + 2 * KIND_KS),
                                          __ldg(so + 2 * KIND_KS + 1)),
                                    255.0f);
#pragma unroll
                for (int c = 0; c < 3; ++c) spec_light[c] = r;
            }
            shade_general<kLight, kShadows>(light, spot_edge0, spot_scale,
                                            color, normal, frag, spec_light,
                                            ns[j], st[j] != 0, rgb[j]);
        }
    }

    float* o = out + 3 * p;
    if constexpr (P == 4) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const int i = 4 * q;
            __stcs(reinterpret_cast<float4*>(o) + q,
                   make_float4(rgb[i / 3][i % 3], rgb[(i + 1) / 3][(i + 1) % 3],
                               rgb[(i + 2) / 3][(i + 2) % 3],
                               rgb[(i + 3) / 3][(i + 3) % 3]));
        }
    } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) __stcs(o + c, rgb[0][c]);
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kVec, int kLight, bool kShadows, bool kSkyPlane>
void launch(unsigned blocks, cudaStream_t stream, const int* tid,
            const int* stencil, const float* gb, const int* samp,
            const int* samp_mask, const float* scale_off, int n_models,
            const float* light, const float* background, float spot_edge0,
            float spot_scale, long long n_pix, float* out) {
    shade_kernel<kVec, kLight, kShadows, kSkyPlane>
        <<<blocks, K9_THREADS, 0, stream>>>(
            tid, stencil, gb, samp, samp_mask, scale_off, n_models, light,
            background, spot_edge0, spot_scale, n_pix, out);
}

// The instance of each (light type, shadows, background kind), 16-byte or
// scalar.
template <bool kVec, int kLight>
void launch_light(bool shadows, bool sky_plane, unsigned blocks,
                  cudaStream_t stream, const int* tid, const int* stencil,
                  const float* gb, const int* samp, const int* samp_mask,
                  const float* scale_off, int n_models, const float* light,
                  const float* background, float spot_edge0, float spot_scale,
                  long long n_pix, float* out) {
    if (shadows && sky_plane)
        launch<kVec, kLight, true, true>(blocks, stream, tid, stencil, gb,
                                         samp, samp_mask, scale_off, n_models,
                                         light, background, spot_edge0,
                                         spot_scale, n_pix, out);
    else if (shadows)
        launch<kVec, kLight, true, false>(blocks, stream, tid, stencil, gb,
                                          samp, samp_mask, scale_off,
                                          n_models, light, background,
                                          spot_edge0, spot_scale, n_pix, out);
    else if (sky_plane)
        launch<kVec, kLight, false, true>(blocks, stream, tid, stencil, gb,
                                          samp, samp_mask, scale_off,
                                          n_models, light, background,
                                          spot_edge0, spot_scale, n_pix, out);
    else
        launch<kVec, kLight, false, false>(blocks, stream, tid, stencil, gb,
                                           samp, samp_mask, scale_off,
                                           n_models, light, background,
                                           spot_edge0, spot_scale, n_pix,
                                           out);
}

template <bool kVec>
void launch_vec(int light_type, bool shadows, bool sky_plane,
                unsigned blocks, cudaStream_t stream, const int* tid,
                const int* stencil, const float* gb, const int* samp,
                const int* samp_mask, const float* scale_off, int n_models,
                const float* light, const float* background, float spot_edge0,
                float spot_scale, long long n_pix, float* out) {
    if (light_type == DIRECTIONAL)
        launch_light<kVec, DIRECTIONAL>(shadows, sky_plane, blocks, stream,
                                        tid, stencil, gb, samp, samp_mask,
                                        scale_off, n_models, light,
                                        background, spot_edge0, spot_scale,
                                        n_pix, out);
    else if (light_type == SPOT)
        launch_light<kVec, SPOT>(shadows, sky_plane, blocks, stream, tid,
                                 stencil, gb, samp, samp_mask, scale_off,
                                 n_models, light, background, spot_edge0,
                                 spot_scale, n_pix, out);
    else
        launch_light<kVec, POINT>(shadows, sky_plane, blocks, stream, tid,
                                  stencil, gb, samp, samp_mask, scale_off,
                                  n_models, light, background, spot_edge0,
                                  spot_scale, n_pix, out);
}

}  // namespace

// stencil: null without shadows; samp, samp_mask and scale_off: null where
// the scene has no texture map; sky_plane: background is the (H, W, 3)
// skybox plane, else a colour of 3 floats.
TR_EXPORT int tr_shade(const int* tid, const int* stencil, const float* gb,
                       const int* samp, const int* samp_mask,
                       const float* scale_off, int n_models,
                       const float* light, int light_type,
                       const float* background, int sky_plane,
                       float spot_edge0, float spot_scale, int height,
                       int width, float* out, void* stream) {
    const long long n_pix = (long long)height * width;
    if (n_pix == 0) return (int)cudaSuccess;
    // 16-byte accesses where every plane allows them: the G-buffer's and
    // the samples' plane k start k*H*W words in.
    bool vec = n_pix % PX == 0 && aligned16(tid) && aligned16(gb) &&
               aligned16(out) && (stencil == nullptr || aligned16(stencil)) &&
               (samp == nullptr || (aligned16(samp) && aligned16(samp_mask))) &&
               (!sky_plane || aligned16(background));
    const long long groups = vec ? n_pix / PX : n_pix;
    const unsigned blocks = (unsigned)((groups + K9_THREADS - 1) / K9_THREADS);
    const cudaStream_t s = (cudaStream_t)stream;
    if (vec)
        launch_vec<true>(light_type, stencil != nullptr, sky_plane != 0,
                         blocks, s, tid, stencil, gb, samp, samp_mask,
                         scale_off, n_models, light, background, spot_edge0,
                         spot_scale, n_pix, out);
    else
        launch_vec<false>(light_type, stencil != nullptr, sky_plane != 0,
                          blocks, s, tid, stencil, gb, samp, samp_mask,
                          scale_off, n_models, light, background, spot_edge0,
                          spot_scale, n_pix, out);
    return (int)cudaGetLastError();
}
