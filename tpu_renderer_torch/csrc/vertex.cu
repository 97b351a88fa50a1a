// K10 vertex: the per-face vertex pass of a frame, from the stacked
// vertices to the tables every raster kernel reads.
//
// Not the counterpart of a pallas_call: the JAX package computes this in
// XLA (tpu_renderer/ops/vertex.py, transform_vertices and gather_faces,
// then pipeline._build_face_batch and raster_pallas.pack_faces :261,
// face_flags :238, pack_face_attrs :1245 and pack_slim_attrs :1278). The
// port's plain version (raster_cuda.vertex_faces_plain) is the same
// composition in PyTorch: some 160 kernels of a few microseconds each on
// the card, every one a node of the frame's CUDA graph. Here it is one
// launch.
//
// One thread per face g of the stacked face tables. It reads the face's
// three vertex ids, the three vertices (float4 rows of the stacked (V, 4)
// table) and, per layout, its row of the packing constants (consts, the
// C_COLS columns of raster_cuda.attr_consts: the general layout's columns
// with world zero, then pm, pr, ka) and its bits word (raster_cuda.
// face_bits), and
// - transforms each vertex as vertex.transform_vertices: clip = v * MVP
//   (rowvec), inv_w = 1/w, ndc = clip * inv_w (all four components),
//   screen = ndc * viewport, the linearized depth of screen z;
// - forms gather_faces' masks and coefficients: the screen-normal cull
//   (CULL instances), the barycentric denominator and the degenerate test,
//   the affine coefficients av .. cz, the bound box (amin/amax, clamped,
//   ceiled, cast to int) and its validity, and valid with the padding mask;
// - writes the face's fdata row (pack_faces: the coefficients, 1/w, the
//   box as float, the clip planes pre-scaled by 1/w), its flag word
//   (face_flags: valid, clip_en, z_write, and the per-pixel clip test
//   unless all three vertices lie strictly inside every plane, of the
//   debug camera too in the DBG instances), the debug camera's pre-scaled
//   planes (pack_debug_planes, DBG instances), and its shading row in the
//   frame's layout: the general layout's 42 columns (pack_face_attrs:
//   world, then the constants, vn where the model has vertex normals, else
//   the unit face normal), or a slim layout's 3, 9 or 23 (pack_slim_attrs);
//   the slim instances also write the face's world positions, which the
//   shadow pass reads (the general row holds them in its first 9 columns).
// The camera (MVP, viewport, near, far) and the debug camera's MVP are read
// through their pointers, staged once per block in shared memory, so a
// captured frame replays with each frame's camera. A block's 128 faces
// write each output table through shared memory: each thread puts its
// face's row there, then the block writes its rows, which lie together in
// the table, in consecutive words (a thread writing its own row, each
// store of a warp would touch 32 rows); the packing constants come in
// 16-byte loads of their row.
//
// Bit-identity with the plain version comes from the library's
// -fmad=false, __fdiv_rn for each division the plain version makes, and
// every sum in its left-to-right order. Two places follow what PyTorch's
// CUDA kernels do, probed on the H100:
// - `1.0 / x` (the 1/w and 1/denominator) is aten::reciprocal, 1.0f / x
//   correctly rounded, then a multiply by 1.0: the same value;
// - the face normal's torch.linalg.vector_norm over its 3 components runs
//   PyTorch's reduction with two lanes per row: lane 0 sums the squares of
//   components 0 and 2, lane 1 that of component 1, and a shuffle adds
//   them, so the norm is sqrt((x*x + z*z) + y*y).
// The bound box follows torch's NaN rules (amin, amax and clamp propagate
// NaN) and its cast: a float-to-int conversion that saturates and takes
// NaN to 0, as torch's does on the card. The min and max of non-NaN values
// are the same in any order up to the sign of a zero, which the int cast
// removes; box_valid compares with > only.
//
// What bounds it on the H100: bytes. Per face it reads 24 B of ids, 48 B of
// vertices (mostly from L2: a vertex is shared by about six faces) and the
// constant columns of its layout (132 B general), and writes 136 B of
// fdata, 4 B of flags and the shading row (168 B general), 72 B more with
// a debug camera: under 0.5 KB a face, 2.4 MB for the flagship's 4,994
// faces, 48 MB for the crowd's 99,842 (chip_smoke.vertex_bytes), which
// 3.35 TB/s moves in 0.7 and 14 us. Each thread's chain of a few hundred
// float operations is short beside that. A thread that wrote its own rows
// would make each store of a warp touch 32 rows of a table; the staged,
// consecutive stores and the 16-byte constant loads keep the crowd's
// launch within twice its bytes' time on the H100. At the flagship's size
// (40 blocks) the launch itself is most of the time.
#include "common.cuh"

namespace {

constexpr int VERTEX_THREADS = 128;
// Packing constants (raster_cuda.attr_consts): the general layout's
// columns with world (0-8) zero and vn (15-23) zero where the model has no
// vertex normals, then pm, pr and ka of the pbr layout and a zero word:
// rows of twelve 16-byte words.
constexpr int C_PBR = A_COLS;
constexpr int C_COLS = A_COLS + 6;
static_assert(C_COLS % 4 == 0, "16-byte rows of packing constants");
// Columns of the general shading row (pack_face_attrs).
constexpr int A_UV = 9, A_VN = 15, A_KD = 24;
// The face's bits word (raster_cuda.face_bits).
constexpr int FB_HAS_VN = 1, FB_CLIP = 2, FB_ZWRITE = 4, FB_REAL = 8;
// Shading layouts (raster_cuda.VERTEX_LAYOUT_ID) and their row widths.
constexpr int GENERAL = 0, FLAT = 1, GOURAUD = 2, PBR = 3;
constexpr int FLAG_CLIP_EN = 2;
static_assert(FB_CLIP == FLAG_CLIP_EN && FB_ZWRITE == FLAG_ZWRITE,
              "clip_en and z_write keep their bits in the flag word");

__host__ __device__ constexpr int row_cols(int layout) {
    return layout == GENERAL ? A_COLS
           : layout == FLAT  ? 3
           : layout == GOURAUD ? 9
                               : 23;
}

// PyTorch's `1.0 / x` on the card: reciprocal (1.0f / x), then * 1.0.
__device__ __forceinline__ float recip(float x) {
    return __fmul_rn(__fdiv_rn(1.0f, x), 1.0f);
}

// torch.amin / amax of three values: NaN if any is NaN.
__device__ __forceinline__ float min3_nan(float a, float b, float c) {
    return (isnan(a) || isnan(b) || isnan(c)) ? NAN : fminf(fminf(a, b), c);
}
__device__ __forceinline__ float max3_nan(float a, float b, float c) {
    return (isnan(a) || isnan(b) || isnan(c)) ? NAN : fmaxf(fmaxf(a, b), c);
}

// ops/vertex._conds' six plane conditions of a clip-space vertex, each
// times inv_w: e[j] for j = x+w, w-x, y+w, w-y, z+w, w-z.
__device__ __forceinline__ void planes(float4 c, float inv_w, float* e) {
    e[0] = (c.x + c.w) * inv_w;
    e[1] = (c.w - c.x) * inv_w;
    e[2] = (c.y + c.w) * inv_w;
    e[3] = (c.w - c.y) * inv_w;
    e[4] = (c.z + c.w) * inv_w;
    e[5] = (c.w - c.z) * inv_w;
}

// A launch's arguments (tr_vertex).
struct VertexArgs {
    const float* verts;
    const long long* vid;
    const float* consts;
    const int* bits;
    const float *mvp, *viewport, *near, *far, *dbg_mvp;
    int n_faces, height, width;
    float* fdata;
    int* flags;
    float *fdbg, *rows, *world;
};

template <int LAYOUT, bool CULL, bool DBG>
__global__ void __launch_bounds__(VERTEX_THREADS)
vertex_kernel(const VertexArgs a) {
    // The camera, staged once per block: MVP, viewport, near and far, then
    // the debug camera's MVP.
    __shared__ float s_cam[16 + 16 + 2 + 16];
    // One output table's rows of the block's faces at a time, written out
    // together (flush): each thread puts its face's row at t * cols.
    __shared__ float s_rows[VERTEX_THREADS * A_COLS];
    const int t = threadIdx.x;
    if (t < 16) {
        s_cam[t] = a.mvp[t];
        s_cam[16 + t] = a.viewport[t];
        if (DBG) s_cam[34 + t] = a.dbg_mvp[t];
    } else if (t < 18) {
        s_cam[16 + t] = t == 16 ? *a.near : *a.far;
    }
    __syncthreads();
    const long long g0 = (long long)blockIdx.x * VERTEX_THREADS;
    const int n_live = (int)min((long long)VERTEX_THREADS, a.n_faces - g0);
    // A thread past the last face computes the last face again and
    // writes nothing of it.
    const long long g = g0 + min(t, n_live - 1);
    // The block's rows of a table of `cols` columns: each thread's row
    // from shared memory to `out`, the block's n_live rows contiguous
    // there, so consecutive threads write consecutive words.
    auto flush = [&](float* out, int cols) {
        __syncthreads();
        float* dst = out + g0 * cols;
        for (int i = t; i < n_live * cols; i += VERTEX_THREADS)
            dst[i] = s_rows[i];
        __syncthreads();
    };
    const float* m = s_cam;
    const float* vp = s_cam + 16;
    const float zn = s_cam[32], zf = s_cam[33];
    // linearize_z's constants, as (2 * near) * far, far + near, far - near.
    const float nf2 = (2.0f * zn) * zf;
    const float fpn = zf + zn, fmn = zf - zn;

    // The face's fdata row (pack_faces) is staged as its values come: the
    // clip planes pre-scaled by 1/w and 1/w with each vertex, so that no
    // vertex's clip space stays in registers.
    float* row = s_rows + t * F_COLS;
    bool all_inside = true;
    float4 wv[3];
    float inv_w[3], sx[3], sy[3], zl[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const long long id = __ldg(a.vid + g * 3 + k);
        wv[k] = __ldg(reinterpret_cast<const float4*>(a.verts) + id);
        const float4 clip = rowvec(wv[k], m);
        inv_w[k] = recip(clip.w);
        const float4 ndc =
            make_float4(clip.x * inv_w[k], clip.y * inv_w[k],
                        clip.z * inv_w[k], clip.w * inv_w[k]);
        const float4 scr = rowvec(ndc, vp);
        sx[k] = scr.x;
        sy[k] = scr.y;
        zl[k] = __fdiv_rn(nf2, fpn - scr.z * fmn);
        float e[6];
        planes(clip, inv_w[k], e);
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            row[F_CLIP + 6 * k + j] = e[j];
            all_inside &= e[j] > 0.0f;
        }
        row[F_INV_W + k] = inv_w[k];
    }
    const int fb = __ldg(a.bits + g);

    // gather_faces: cull, denominator, affine coefficients, bound box.
    const float v0x = sx[1] - sx[0], v0y = sy[1] - sy[0];
    const float v1x = sx[2] - sx[0], v1y = sy[2] - sy[0];
    const bool culled = CULL && (v0x * v1y - v0y * v1x) < 0.0f;
    const float d00 = v0x * v0x + v0y * v0y;
    const float d01 = v0x * v1x + v0y * v1y;
    const float d11 = v1x * v1x + v1y * v1y;
    const float denom = d00 * d11 - d01 * d01;
    const bool degenerate = denom == 0.0f;
    const float inv_denom = recip(degenerate ? 1.0f : denom);
    const float ax = sx[0], ay = sy[0];
    const float av = (d11 * v0x - d01 * v1x) * inv_denom;
    const float bv = (d11 * v0y - d01 * v1y) * inv_denom;
    const float cv = -(ax * av + ay * bv);
    const float aw = (d00 * v1x - d01 * v0x) * inv_denom;
    const float bw = (d00 * v1y - d01 * v0y) * inv_denom;
    const float cw = -(ax * aw + ay * bw);
    const float z10 = zl[1] - zl[0], z20 = zl[2] - zl[0];
    const float az = av * z10 + aw * z20;
    const float bz = bv * z10 + bw * z20;
    const float cz = (zl[0] + cv * z10) + cw * z20;

    float min_x = min3_nan(sx[0], sx[1], sx[2]);
    float max_x = max3_nan(sx[0], sx[1], sx[2]);
    float min_y = min3_nan(sy[0], sy[1], sy[2]);
    float max_y = max3_nan(sy[0], sy[1], sy[2]);
    // torch.clamp: NaN stays NaN.
    min_x = isnan(min_x) ? min_x : fmaxf(min_x, 0.0f);
    max_x = isnan(max_x) ? max_x : fminf(max_x, (float)a.width);
    min_y = isnan(min_y) ? min_y : fmaxf(min_y, 0.0f);
    max_y = isnan(max_y) ? max_y : fminf(max_y, (float)a.height);
    const bool box_valid = !((min_x > max_x) || (min_y > max_y));
    const bool valid =
        !culled && !degenerate && box_valid && (fb & FB_REAL) != 0;

    // The rest of the fdata row.
    row[F_AFF + 0] = av;
    row[F_AFF + 1] = bv;
    row[F_AFF + 2] = cv;
    row[F_AFF + 3] = aw;
    row[F_AFF + 4] = bw;
    row[F_AFF + 5] = cw;
    row[F_AFF + 6] = az;
    row[F_AFF + 7] = bz;
    row[F_AFF + 8] = cz;
    row[F_BBOX + 0] = (float)static_cast<int>(ceilf(min_x));
    row[F_BBOX + 1] = (float)static_cast<int>(ceilf(max_x));
    row[F_BBOX + 2] = (float)static_cast<int>(ceilf(min_y));
    row[F_BBOX + 3] = (float)static_cast<int>(ceilf(max_y));
    flush(a.fdata, F_COLS);
    // pack_debug_planes.
    if (DBG) {
        row = s_rows + t * DBG_COLS;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float e[6];
            planes(rowvec(wv[k], s_cam + 34), inv_w[k], e);
#pragma unroll
            for (int j = 0; j < 6; ++j) {
                row[6 * k + j] = e[j];
                all_inside &= e[j] > 0.0f;
            }
        }
        flush(a.fdbg, DBG_COLS);
    }
    // face_flags.
    const bool clip_en = (fb & FB_CLIP) != 0;
    if (t < n_live)
        a.flags[g] = (valid ? FLAG_VALID : 0) | (fb & (FB_CLIP | FB_ZWRITE)) |
                     (clip_en && !all_inside ? FLAG_PPC : 0);

    // The slim layouts' face positions.
    if (LAYOUT != GENERAL) {
        row = s_rows + t * 9;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            row[3 * k + 0] = wv[k].x;
            row[3 * k + 1] = wv[k].y;
            row[3 * k + 2] = wv[k].z;
        }
        flush(a.world, 9);
    }

    // The shading row. The unit face normal of the world positions
    // (pipeline's normalize(_cross(w1 - w0, w2 - w0))) where a layout
    // reads it: the flat layout, and vn of a face without vertex normals.
    const bool has_vn = (fb & FB_HAS_VN) != 0;
    float fn[3] = {0.0f, 0.0f, 0.0f};
    if (LAYOUT == FLAT || !has_vn) {
        const float ex = wv[1].x - wv[0].x, ey = wv[1].y - wv[0].y,
                    ez = wv[1].z - wv[0].z;
        const float gx = wv[2].x - wv[0].x, gy = wv[2].y - wv[0].y,
                    gz = wv[2].z - wv[0].z;
        const float c[3] = {ey * gz - ez * gy, ez * gx - ex * gz,
                            ex * gy - ey * gx};
        float l2 = sqrtf((c[0] * c[0] + c[2] * c[2]) + c[1] * c[1]);
        if (l2 == 0.0f) l2 = 1.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) fn[j] = __fdiv_rn(c[j], l2);
    }
    // The face's packing constants that the layout reads, in 16-byte
    // loads of its C_COLS-word row: general 8-43, gouraud 12-23 (vn), pbr
    // 12-47; flat none.
    constexpr int q_lo = LAYOUT == GENERAL ? 2 : 3;
    constexpr int q_hi = LAYOUT == GENERAL ? 11
                         : LAYOUT == PBR   ? C_COLS / 4
                         : LAYOUT == GOURAUD ? 6
                                             : 3;
    float cst[C_COLS];
    const float4* cg = reinterpret_cast<const float4*>(a.consts) +
                       g * (C_COLS / 4);
#pragma unroll
    for (int q = q_lo; q < q_hi; ++q) {
        const float4 v = __ldg(cg + q);
        cst[4 * q] = v.x;
        cst[4 * q + 1] = v.y;
        cst[4 * q + 2] = v.z;
        cst[4 * q + 3] = v.w;
    }
    row = s_rows + t * row_cols(LAYOUT);
    // vn, 9 columns: the table's where the face has vertex normals, else
    // the face normal at each vertex.
    auto put_vn = [&](float* out) {
#pragma unroll
        for (int i = 0; i < 9; ++i)
            out[i] = has_vn ? cst[A_VN + i] : fn[i % 3];
    };
    if (LAYOUT == GENERAL) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            row[3 * k + 0] = wv[k].x;
            row[3 * k + 1] = wv[k].y;
            row[3 * k + 2] = wv[k].z;
        }
#pragma unroll
        for (int i = A_UV; i < A_VN; ++i) row[i] = cst[i];
        put_vn(row + A_VN);
#pragma unroll
        for (int i = A_KD; i < A_COLS; ++i) row[i] = cst[i];
    } else if (LAYOUT == FLAT) {
#pragma unroll
        for (int j = 0; j < 3; ++j) row[j] = fn[j];
    } else {
        put_vn(row);
        if (LAYOUT == PBR) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                row[9 + k] = sx[k];
                row[12 + k] = sy[k];
                row[15 + k] = zl[k];
            }
#pragma unroll
            for (int i = 0; i < 5; ++i) row[18 + i] = cst[C_PBR + i];
        }
    }
    flush(a.rows, row_cols(LAYOUT));
}

// The instance of (culling, debug camera) for one layout.
template <int LAYOUT>
void launch(bool cull, bool dbg, unsigned blocks, cudaStream_t s,
            const VertexArgs& a) {
    constexpr int T = VERTEX_THREADS;
    if (cull && dbg)
        vertex_kernel<LAYOUT, true, true><<<blocks, T, 0, s>>>(a);
    else if (cull)
        vertex_kernel<LAYOUT, true, false><<<blocks, T, 0, s>>>(a);
    else if (dbg)
        vertex_kernel<LAYOUT, false, true><<<blocks, T, 0, s>>>(a);
    else
        vertex_kernel<LAYOUT, false, false><<<blocks, T, 0, s>>>(a);
}

}  // namespace

// vid: (G, 3) int64 ids into verts (V, 4), 16-byte aligned; consts (G,
// C_COLS) and bits (G,); mvp and viewport 16 floats each, near and far
// one each, on the card; dbg_mvp 16 floats or null (no debug camera, then
// fdbg is null too); layout 0 general, 1 flat, 2 gouraud, 3 pbr; world:
// (G, 9) floats for the slim layouts, null for the general one.
TR_EXPORT int tr_vertex(const float* verts, const long long* vid,
                        const float* consts, const int* bits,
                        const float* mvp, const float* viewport,
                        const float* near, const float* far,
                        const float* dbg_mvp, int n_faces, int height,
                        int width, int culling, int layout, float* fdata,
                        int* flags, float* fdbg, float* rows, float* world,
                        void* stream) {
    if (n_faces == 0) return (int)cudaSuccess;
    const VertexArgs a{verts, vid,  consts, bits,   mvp,   viewport,
                       near,  far,  dbg_mvp, n_faces, height, width,
                       fdata, flags, fdbg,  rows,   world};
    const unsigned blocks =
        (unsigned)((n_faces + VERTEX_THREADS - 1) / VERTEX_THREADS);
    const cudaStream_t s = (cudaStream_t)stream;
    const bool cull = culling != 0, dbg = dbg_mvp != nullptr;
    if (layout == GENERAL)
        launch<GENERAL>(cull, dbg, blocks, s, a);
    else if (layout == FLAT)
        launch<FLAT>(cull, dbg, blocks, s, a);
    else if (layout == GOURAUD)
        launch<GOURAUD>(cull, dbg, blocks, s, a);
    else if (layout == PBR)
        launch<PBR>(cull, dbg, blocks, s, a);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
