"""The port's modules against their JAX counterparts on identical inputs.

Each kernel's plain version (what its wrapper runs on the CPU) is fed the
JAX package's own per-face tensors of the test_torch_slice scene, converted
through numpy, and compared with the JAX function it replaces:

- K1 visibility vs raster_xla.zbuffer_pass / visibility_pass;
- K2 gbuffer vs the G-buffer of visibility_gbuffer_pallas (interpret mode,
  with_tex_tables=True);
- K3 sample_textures vs pipeline._wrap_index + the stack gather of
  _sample_stack on the JAX G-buffer's iu/iv, and vs _wrap_index + a
  gather from each texture on seeded uv in [-4, 4] and textures of no
  power-of-two size;
- K4 stencil vs shadow.shadow_stencil (XLA).

Tolerances and why: XLA's CPU backend contracts a*b + c into fused
multiply-adds (measured here: 24% of f32 a*b + c results differ from the
separately rounded ones), while the port rounds every op, so float outputs
agree to a few ulps, not bit for bit; integer outputs (tid, texels,
stencil) are compared exactly or at the JAX package's own 99.9% bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer.models.camera import camera_matrices as cm_jax
from tpu_renderer.ops import frustum as fr_jax
from tpu_renderer.ops import pipeline as pl_jax
from tpu_renderer.ops.raster_pallas import visibility_gbuffer_pallas
from tpu_renderer.ops.raster_xla import visibility_pass, zbuffer_pass
from tpu_renderer.ops.shadow import shadow_stencil
from tpu_renderer_torch.constants import PROJECTION_TYPE, SUBSYSTEM, SYSTEM
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models.camera import camera_matrices as cm_torch
from tpu_renderer_torch.ops import frustum as fr_torch
from tpu_renderer_torch.ops import pipeline as pl_torch
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops.shadow import shadow_stencil as stencil_torch
from tpu_renderer_torch.ops.vertex import gather_faces, transform_vertices
import tpu_renderer as tj
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer_torch.models import gizmos as gz_torch
from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread)

H, W = RES


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy tree -> torch tree (CPU)."""
    def conv(a):
        a = np.asarray(a)
        return torch.from_numpy(a.copy())
    return {k: conv(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_stage():
    """The JAX package's prepared scene and its per-face tensors."""
    scene = build_scene(tj, gz_jax)
    cfg, dyn = scene._prepare()
    cam_m = pl_jax._cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    faces, attrs = jax.jit(
        lambda d, c: pl_jax._build_face_batch(cfg, d, c, None))(dyn, cam_m)
    return cfg, dyn, cam_m, _np_tree(faces), _np_tree(attrs)


@pytest.fixture(scope="module")
def torch_stage():
    scene = build_scene(tt, gz_torch, device="cpu")
    cfg, dyn = scene._prepare()
    cam_m = pl_torch._cam_matrices(cfg, dyn["camera"], "cpu")
    return cfg, dyn, cam_m


@pytest.fixture(scope="module")
def packed(jax_stage):
    """The port's packed tables built from the JAX per-face tensors."""
    _, _, _, faces, attrs = jax_stage
    ft, at = _t(faces), _t(attrs)
    return rc.pack_faces(ft), rc.face_flags(ft), rc.pack_face_attrs(at), at


@pytest.fixture(scope="module")
def jax_gbuffer(jax_stage):
    cfg, _, _, faces, attrs = jax_stage
    zb, tid, gb = visibility_gbuffer_pallas(
        faces, attrs, H, W, cfg.system, interpret=True,
        with_tex_tables=True)
    return np.asarray(zb), np.asarray(tid), np.asarray(gb)


def test_camera_matrices_match(jax_stage, torch_stage):
    cfg, dyn, _, _, _ = jax_stage
    c = dyn["camera"]
    for projection, system, subsystem in [
            (PROJECTION_TYPE.PERSPECTIVE, SYSTEM.LH, SUBSYSTEM.OPENGL),
            (PROJECTION_TYPE.PERSPECTIVE, SYSTEM.RH, SUBSYSTEM.DIRECTX)]:
        kw = dict(projection_type=projection, system=system,
                  subsystem=subsystem, resolution=RES)
        args = (c["position"], c["center"], c["up"], c["fovy"], c["near"],
                c["far"])
        mj = cm_jax(*args, **kw)
        mt = cm_torch(*map(np.asarray, args), **kw)
        for key in ("lookat", "projection", "MVP", "viewport",
                    "frustum_planes"):
            np.testing.assert_allclose(mt[key].numpy(), np.asarray(mj[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


def test_vertex_stage_matches_gather_faces(jax_stage, torch_stage):
    """transform_vertices + gather_faces of the port vs the JAX package's
    face batch for the same model and camera."""
    _, _, _, faces_j, attrs_j = jax_stage
    cfg, dyn, cam_m = torch_stage
    faces_j = dict(faces_j, world=attrs_j["world"])
    off = 0
    for md in dyn["models"]:
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                dyn["camera"]["near"], dyn["camera"]["far"])
        f = gather_faces(va, md["vid"], H, W, cfg.backface_culling)
        n = md["vid"].shape[0]
        for key in ("sx", "sy", "szlin", "inv_w", "clip", "world"):
            # 1e-6 relative to each array's magnitude: the JAX program's
            # fused matrix products round differently, and a coordinate
            # near 0 (sy = h/2 + h/2 * ndc_y) carries its operands' error.
            # Linearized depth divides by far + near - z*(far - near) with
            # z near 1, which amplifies its inputs' ulps ~10x: 1e-5 there.
            want = faces_j[key][off:off + n]
            rtol = 1e-5 if key == "szlin" else 1e-6
            np.testing.assert_allclose(f[key].numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(),
                                       err_msg=key)
        np.testing.assert_array_equal(
            f["valid"].numpy() & md["pad_valid"].numpy(),
            faces_j["valid"][off:off + n])
        np.testing.assert_array_equal(f["bbox"].numpy(),
                                      faces_j["bbox"][off:off + n])
        off += n


def test_gather_faces_aff_matches(jax_stage):
    """The per-face affine coefficients (vertex.py:105-126 of the JAX
    package) from the JAX vertex stage's own per-vertex arrays, run op by
    op (no fused multiply-adds): bit-identical."""
    import tpu_renderer.ops.vertex as vx_jax

    cfg, dyn, cam_m, _, _ = jax_stage
    for md in dyn["models"]:
        va = vx_jax.transform_vertices(md["verts"], cam_m["MVP"],
                                       cam_m["viewport"], dyn["camera"]["near"],
                                       dyn["camera"]["far"])
        fj = _np_tree(vx_jax.gather_faces(va, md["vid"], H, W, True))
        ft = gather_faces(_t(_np_tree(va)), torch.from_numpy(
            np.array(md["vid"])), H, W, True)
        for key in ("aff", "valid", "bbox", "denom"):
            np.testing.assert_array_equal(ft[key].numpy(), fj[key],
                                          err_msg=key)


def test_clip_polygon_counts_match():
    """Batched clip_polygon vs the JAX package's vmapped clip_polygon on
    random quads straddling the frustum: equal counts, close vertices."""
    rng = np.random.default_rng(1)
    m = cm_torch(np.array([2, 2.5, 4], np.float32), np.zeros(3, np.float32),
                 np.array([0, 1, 0], np.float32), 60, 0.01, 50,
                 projection_type=PROJECTION_TYPE.PERSPECTIVE,
                 system=SYSTEM.LH, subsystem=SUBSYSTEM.OPENGL, resolution=RES)
    planes = m["frustum_planes"].numpy()
    verts = np.zeros((256, 16, 4), np.float32)
    verts[:, :4, :3] = rng.uniform(-6, 6, (256, 4, 3))
    verts[:, :4, 3] = 1.0
    counts = np.full(256, 4, np.int32)
    vj, cj = jax.vmap(lambda v, c: fr_jax.clip_polygon(v, c, planes))(
        verts, counts)
    vt, ct = fr_torch.clip_polygon(torch.from_numpy(verts),
                                   torch.from_numpy(counts),
                                   torch.from_numpy(planes))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert 0 < (ct.numpy() == 0).sum() < 256           # some fully clipped
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


def test_k1_visibility_matches_xla(jax_stage, packed):
    cfg, _, _, faces, _ = jax_stage
    fdata, flags, _, _ = packed
    zb_j = np.asarray(zbuffer_pass(faces, H, W, cfg.system))
    tid_j = np.asarray(visibility_pass(faces, zb_j, H, W, cfg.system))
    zb_t, tid_t = rc.visibility(fdata, flags, H, W, cfg.system)
    zb_t, tid_t = zb_t.numpy(), tid_t.numpy()
    same = tid_t == tid_j
    assert same.mean() >= 0.999
    assert (tid_t >= 0).any()
    np.testing.assert_array_equal(np.isinf(zb_t), np.isinf(zb_j))
    fin = same & np.isfinite(zb_j)
    # A few ulps (XLA's fused multiply-adds, see the module docstring).
    np.testing.assert_allclose(zb_t[fin], zb_j[fin], rtol=5e-7, atol=0)


def test_k2_gbuffer_matches_pallas(jax_gbuffer, packed):
    _, tid_j, gb_j = jax_gbuffer
    fdata, _, adata, _ = packed
    gb_t = rc.gbuffer(fdata, adata, torch.from_numpy(tid_j)).numpy()
    assert gb_t.shape == gb_j.shape == (rc.GB_CHANNELS, H, W)
    win = tid_j >= 0
    assert win.any()
    np.testing.assert_allclose(gb_t[:, win], gb_j[:, win], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gb_t[:, ~win], 0.0)


def test_k3_sample_textures_match_jax_gather(jax_stage, jax_gbuffer, packed,
                                             torch_stage):
    cfg, dyn, _, _, _ = jax_stage
    _, tid_j, gb_j = jax_gbuffer
    _, _, _, attrs_t = packed
    dyn_t = dyn_from_numpy(_np_tree(dyn), "cpu")
    cfg_t = torch_stage[0]
    tables = pl_torch.texture_tables(cfg_t, dyn_t, attrs_t)
    samp, mask = rc.sample_textures(
        torch.from_numpy(tid_j), torch.from_numpy(gb_j[rc.GB_IU].copy()),
        torch.from_numpy(gb_j[rc.GB_IV].copy()), *tables)
    samp, mask = samp.numpy(), mask.numpy()

    iu, iv = jnp.asarray(gb_j[rc.GB_IU]), jnp.asarray(gb_j[rc.GB_IV])
    model_id = gb_j[rc.GB_MODEL]
    n_sampled = 0
    for k, kind in enumerate(rc.KINDS):
        base = {"kd": rc.GB_KD_SLOT, "norm": rc.GB_NORM_SLOT,
                "ks": rc.GB_KS_SLOT}[kind]
        want_mask = np.zeros((H, W), bool)
        want = np.zeros((H, W), np.int64)
        for m, md in enumerate(dyn["models"]):
            if f"{kind}_stack" not in md:
                continue
            slot = gb_j[base]
            th, tw = jnp.asarray(gb_j[base + 1]), jnp.asarray(gb_j[base + 2])
            col = pl_jax._wrap_index(jnp.clip(iu, max=1.0) * (tw - 1), tw)
            row = pl_jax._wrap_index((1.0 - jnp.clip(iv, max=1.0)) * (th - 1),
                                     th)
            sel = (tid_j >= 0) & (model_id == m) & (slot >= 0)
            texel = np.asarray(md[f"{kind}_stack"])[
                np.where(sel, slot, 0).astype(np.int32),
                np.where(sel, np.asarray(row), 0),
                np.where(sel, np.asarray(col), 0)]
            want = np.where(sel, texel, want)
            want_mask |= sel
        np.testing.assert_array_equal((mask >> k) & 1, want_mask)
        np.testing.assert_array_equal(samp[k][want_mask], want[want_mask])
        n_sampled += want_mask.sum()
    assert n_sampled > 0


@pytest.mark.parametrize("seed,gid0", [(0, 0), (1, 23)])
def test_k3_plain_matches_jax_wrap_on_npot_textures(seed, gid0):
    """K3's plain version against pipeline._wrap_index and a gather from
    each texture, on seeded finite uv in [-4, 4] (negative, above 1, past
    one wrap) and textures of no power-of-two size, 1x1 among them: equal
    samples and masks, here from ``gid0`` on. NaN and inf are left to the
    card's adversarial case: JAX's astype(int32) of NaN is undefined."""
    rng = np.random.default_rng(seed)
    h, w, g = 24, 29, 40
    dims = np.array([(1, 1), (3, 5), (7, 1), (13, 11), (37, 100), (6, 9)])
    texs = [rng.integers(0, 1 << 24, (th, tw)).astype(np.int32)
            for th, tw in dims]
    sizes = dims.prod(1)
    slots = np.stack([np.cumsum(sizes) - sizes, dims[:, 1]], 1)
    slot = rng.integers(-1, len(dims), (g, 3))
    ftex = np.concatenate([slot[..., None], dims[np.maximum(slot, 0)]], -1)
    tid = rng.integers(-1, gid0 + g + 10, (h, w)).astype(np.int32)
    iu, iv = rng.uniform(-4.0, 4.0, (2, h, w)).astype(np.float32)
    samp, mask = rc.sample_textures(
        torch.from_numpy(tid), torch.from_numpy(iu), torch.from_numpy(iv),
        torch.from_numpy(ftex.astype(np.int32)),
        torch.from_numpy(slots.astype(np.int32)),
        torch.from_numpy(np.concatenate([t.ravel() for t in texs])),
        gid0=gid0)
    samp, mask = samp.numpy(), mask.numpy()

    own = (tid >= gid0) & (tid < gid0 + g)
    face = np.where(own, tid - gid0, 0)
    for k in range(3):
        s = slot[face, k]
        th = ftex[face, k, 1].astype(np.float32)
        tw = ftex[face, k, 2].astype(np.float32)
        col = np.asarray(pl_jax._wrap_index(jnp.clip(iu, max=1.0) * (tw - 1),
                                            tw))
        row = np.asarray(pl_jax._wrap_index(
            (1.0 - jnp.clip(iv, max=1.0)) * (th - 1), th))
        sel = own & (s >= 0)
        want = np.zeros((h, w), np.int32)
        for i, tex in enumerate(texs):
            at = sel & (s == i)
            want[at] = tex[row[at], col[at]]
        np.testing.assert_array_equal((mask >> k) & 1, sel)
        np.testing.assert_array_equal(samp[k], want)
        for at in (iu < 0, iu > 1, iv < 0, iv > 1, s == 0, s == 4):
            assert (sel & at).any()


def test_k4_stencil_matches_xla(jax_stage, torch_stage):
    cfg, dyn, cam_m, _, _ = jax_stage
    zbuf = np.asarray(jax.jit(lambda d: pl_jax.render_core(cfg, d)[1])(dyn))
    st_j = np.asarray(jax.jit(
        lambda d, c, z: shadow_stencil(cfg, d, c, z))(dyn, cam_m, zbuf))
    cfg_t, dyn_t, cam_t = torch_stage
    st_t = stencil_torch(cfg_t, dyn_t, cam_t,
                         torch.from_numpy(zbuf * cfg.system))
    np.testing.assert_array_equal(st_t.numpy(), st_j)
    assert (st_j != 0).any()
