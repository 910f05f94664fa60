"""Port parity: core math, the view, the scene tables and the host-side
content pipeline (glTF, PNG, resize) against the JAX package."""

import dataclasses
import io
import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.scene import lights as jlights
from incarnation_tpu.scene import loader as jloader
from incarnation_tpu.scene import instancing as jinstancing
from incarnation_tpu.scene import testing as jtesting
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.core import mathutils as tmu
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.scene import instancing as tinstancing
from incarnation_tpu_torch.scene import lights as tlights
from incarnation_tpu_torch.scene import loader as tloader
from incarnation_tpu_torch.scene import png as tpng
from incarnation_tpu_torch.scene import testing as ttesting
from incarnation_tpu_torch.scene import textures as ttex

torch.set_num_threads(1)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Core math and the view
# ---------------------------------------------------------------------------

def test_octahedral_roundtrip_matches_jax():
    """Same f32 operations in both packages: equal to 1 ulp-ish (2e-7)."""
    n = _unit(np.random.default_rng(0), (512, 3))
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    je = np.asarray(jmu.oct_encode(jnp.asarray(n)))
    te = tmu.oct_encode(torch.as_tensor(n)).numpy()
    np.testing.assert_allclose(te, je, rtol=0, atol=2e-7)
    jd = np.asarray(jmu.oct_decode(jnp.asarray(je)))
    td = tmu.oct_decode(torch.tensor(je)).numpy()
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-7)


def test_visibility_encoding_matches_jax():
    """Integers exactly, including ids with the top bit set (torch >> on
    int32 is arithmetic; the port masks after the shift)."""
    rng = np.random.default_rng(1)
    prim = rng.integers(0, 4095, 256).astype(np.int32)
    tri = rng.integers(0, 1 << 20, 256).astype(np.int32)
    prim[:3] = [4095, 2048, 0]
    jv = np.asarray(jmu.encode_primitive_visibility(jnp.asarray(prim),
                                                    jnp.asarray(tri)))
    tv = tmu.encode_primitive_visibility(torch.as_tensor(prim),
                                         torch.as_tensor(tri)).numpy()
    np.testing.assert_array_equal(tv, jv)
    for a, b in zip(jmu.decode_primitive_visibility(jnp.asarray(jv)),
                    tmu.decode_primitive_visibility(torch.as_tensor(jv))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert tmu.VIS_CLEAR_INT32 == int(jmu.VIS_CLEAR_INT32)


def test_projection_halton_and_view_match_jax():
    """Host numpy math: bit-equal."""
    np.testing.assert_array_equal(
        tmu.perspective_reverse_z_infinite(0.7, 1.6, 0.5),
        np.asarray(jmu.perspective_reverse_z_infinite(0.7, 1.6, 0.5)))
    np.testing.assert_array_equal(tmu.halton_jitter_table(16),
                                  np.asarray(jmu.halton_jitter_table(16)))
    np.testing.assert_array_equal(
        tmu.trs_matrix([1, 2, 3], [0.1, 0.2, 0.3, 0.927], [2, 1, 0.5]),
        np.asarray(jmu.trs_matrix([1, 2, 3], [0.1, 0.2, 0.3, 0.927],
                                  [2, 1, 0.5])))
    jv = JView.from_lookat([1.0, 2.0, -6.0], [0.5, 0.0, 4.0], aspect=2.0)
    tv = TView.from_lookat([1.0, 2.0, -6.0], [0.5, 0.0, 4.0], aspect=2.0)
    jit = [0.3 / 128, -0.2 / 64]
    np.testing.assert_array_equal(tv.view_proj(jit),
                                  np.asarray(jv.view_proj(jit)))
    jv.rotate(yaw=0.1, pitch=-0.05)
    tv.rotate(yaw=0.1, pitch=-0.05)
    np.testing.assert_allclose(tv.view_transform(),
                               np.asarray(jv.view_transform()), atol=1e-6)


def test_latlong_directions_match_jax():
    uv = np.random.default_rng(2).random((64, 2)).astype(np.float32)
    jd = np.asarray(jmu.latlong_uv_to_direction(jnp.asarray(uv)))
    td = tmu.latlong_uv_to_direction(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-7)
    ju = np.asarray(jmu.direction_to_latlong_uv(jnp.asarray(jd)))
    tu = tmu.direction_to_latlong_uv(torch.as_tensor(jd)).numpy()
    np.testing.assert_allclose(tu, ju, rtol=0, atol=2e-7)


# ---------------------------------------------------------------------------
# Scene tables
# ---------------------------------------------------------------------------

def _compare_scene(tscene, jscene, skip=()):
    ta, tmeta = tloader.scene_arrays(tscene)
    ja, jmeta = tloader.scene_arrays(jscene)
    assert tmeta == jmeta
    shared = [k for k in ta if k in ja and k not in skip]
    assert len(shared) >= 30
    for k in shared:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_scene_from_arrays_rich_scene():
    """make_rich_scene (masked quad, decal, point + spot light) carried
    across: every table equal, device tensors of the right dtype."""
    jscene = make_rich_scene()
    arrays, meta = tloader.scene_arrays(jscene)
    tscene = tloader.scene_from_arrays(arrays, meta, "cpu")
    _compare_scene(tscene, jscene)
    assert tscene.meta.has_masked and tscene.meta.has_decals
    assert tscene.meta.num_lights == 2
    assert tscene.tri_corner.dtype == torch.float32
    assert tscene.mat_stack.amask.dtype == torch.int32
    assert tscene.lights.transform.shape[1:] == (4, 4)
    assert tscene.nbytes() > 0


def test_testing_make_rich_scene_matches_jax():
    """The port's own scene/testing.py builder against JAX's: every table
    equal, the decal flag and meta included."""
    _compare_scene(ttesting.make_rich_scene(device="cpu"), make_rich_scene())


def test_testing_make_scene_matches_jax():
    """make_scene with its defaults and with a BLEND primitive, normals,
    UVs and a transform: every table and the meta (has_blend) equal."""
    rng = np.random.default_rng(21)
    pos = rng.normal(size=(6, 3)).astype(np.float32)
    tris = [[0, 1, 2], [3, 4, 5]]
    _compare_scene(ttesting.make_scene(pos, tris, device="cpu"),
                   jtesting.make_scene(pos, tris))
    kw = dict(normals=rng.normal(size=(6, 3)).astype(np.float32),
              uvs=rng.random((6, 2)).astype(np.float32),
              transform=tmu.trs_matrix([1, 2, 3], [0, 0.6, 0, 0.8], None),
              double_sided=True, tri_prim=[0, 1], num_prims=2,
              prim_tri_offset=[0, 1], prim_alpha_mode=[0, 2],
              prim_material=[0, 0])
    t = ttesting.make_scene(pos, tris, device="cpu", **kw)
    _compare_scene(t, jtesting.make_scene(pos, tris, **kw))
    assert t.meta.has_blend and t.meta.has_masked


@pytest.mark.parametrize("name", ["neutral_material_stack",
                                  "checkerboard_alpha_stack",
                                  "two_material_stack"])
def test_testing_material_stacks_match_jax(name):
    """The three small texture stacks: the port's host dict holds the
    arrays of JAX's MaterialTextureStack."""
    j = getattr(jtesting, name)()
    t = getattr(ttesting, name)()
    assert set(t) == {f.name for f in dataclasses.fields(j)}
    for k, v in t.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j, k)),
                                      err_msg=k)
    jm = jtesting.default_material_table()
    for k, v in ttesting.default_material_table().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm, k)),
                                      err_msg=k)


def test_replicate_scene_matches_jax():
    """replicate_scene over a 2 x 2 grid of the rich scene: every table
    equal to JAX's, ids offset per instance, padding ids kept at -1."""
    jscene = make_rich_scene()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    off = tinstancing.grid_offsets(2, 2, 20.0)
    np.testing.assert_array_equal(off, jinstancing.grid_offsets(2, 2, 20.0))
    _compare_scene(tinstancing.replicate_scene(tscene, off),
                   jinstancing.replicate_scene(jscene, off))
    # a scene with -1 padding in tri_prim / tri_meshlet
    arrays, meta = tloader.scene_arrays(jscene)
    for k in ("tri_prim", "tri_meshlet"):
        arrays[k] = arrays[k].copy()
        arrays[k][-1] = -1
    padded = tloader.scene_from_arrays(arrays, meta, "cpu")
    rep = tinstancing.replicate_scene(padded, off[:2])
    assert rep.tri_prim.tolist()[7::8] == [-1, -1]
    assert rep.tri_meshlet.tolist()[7::8] == [-1, -1]
    assert rep.meta.num_primitives == 8 and rep.mesh_transforms.shape[0] == 2


def test_light_table_matches_jax():
    defs = [{"type": "point", "color": [1, 0.5, 0.2], "intensity": 3.0,
             "range": 4.0},
            {"type": "spot", "intensity": 9.0,
             "spot": {"innerConeAngle": 0.2, "outerConeAngle": 0.6}},
            {"type": "directional", "intensity": 2.0}]
    xf = [tmu.trs_matrix([1, 2, 3], [0.1, 0.2, 0.3, 0.927], None)
          for _ in defs]
    jt = jlights.build_light_table(defs, xf)
    tt = tlights.light_table(tlights.light_arrays(defs, xf), "cpu")
    for f in dataclasses.fields(tt):
        a = getattr(tt, f.name)
        b = getattr(jt, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)
    np.testing.assert_allclose(
        tlights.light_direction_toward(tt.transform).numpy(),
        np.asarray(jlights.light_direction_toward(jt.transform)), atol=1e-7)
    np.testing.assert_array_equal(
        tlights.sun_direction_tod(11.0, 200, 42.5),
        np.asarray(jlights.sun_direction_tod(11.0, 200, 42.5)))


def _png_pil(img):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _write_gltf(tmp_path):
    """A two-mesh glTF: a textured, normal-mapped MASK quad (64x64 base
    colour and emissive; 128x128 normal and metal-rough maps ->
    area-downscaled at max_dim 64, vMF-filtered mips), an
    opaque untextured triangle named 'decal_x', a camera and a punctual
    light. (Upscales are held to cv2 in test_resize_matches_cv2: a
    bilinear lerp can round to the other side of a block encoder's
    quantisation step, so they are compared as floats there.)"""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
    nrm = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    (tmp_path / "base.png").write_bytes(_png_pil(base))
    (tmp_path / "nrm.png").write_bytes(_png_pil(nrm))
    pos = np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0],
                    [0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    nor = np.tile(np.array([0, 0, 1], np.float32), (7, 1))
    uv = np.array([[0, 0], [2, 0], [2, 2], [0, 2], [0, 0], [1, 0], [0, 1]],
                  np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3, 0, 1, 2], np.uint16)
    blob = pos.tobytes() + nor.tobytes() + uv.tobytes() + idx.tobytes()
    blob += b"\0" * (-len(blob) % 4)
    (tmp_path / "m.bin").write_bytes(blob)
    o_n, o_uv, o_i = 84, 168, 224

    def acc(view, count, typ, ctype=5126, offset=0):
        return {"bufferView": view, "byteOffset": offset,
                "componentType": ctype, "count": count, "type": typ}

    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1, 2, 3]}],
        "nodes": [
            {"mesh": 0, "translation": [0.5, -1, 4],
             "rotation": [0, 0.3826834, 0, 0.9238795]},
            {"mesh": 1, "name": "decal_x", "scale": [1, 2, 1]},
            {"camera": 0, "translation": [0, 1, -5]},
            {"translation": [1, 3, 2],
             "extensions": {"KHR_lights_punctual": {"light": 0}}},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                            "TEXCOORD_0": 2},
                             "indices": 3, "material": 1}]},
            {"name": "decal_x",
             "primitives": [{"attributes": {"POSITION": 4},
                             "indices": 5, "material": 0}]},
        ],
        "accessors": [
            acc(0, 4, "VEC3"), acc(1, 4, "VEC3"), acc(2, 4, "VEC2"),
            acc(3, 6, "SCALAR", 5123),
            acc(0, 3, "VEC3", offset=48), acc(3, 3, "SCALAR", 5123, 12)],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 84},
            {"buffer": 0, "byteOffset": o_n, "byteLength": 84},
            {"buffer": 0, "byteOffset": o_uv, "byteLength": 56},
            {"buffer": 0, "byteOffset": o_i, "byteLength": 18}],
        "buffers": [{"uri": "m.bin", "byteLength": len(blob)}],
        "images": [{"uri": "base.png"}, {"uri": "nrm.png"}],
        "samplers": [{"wrapS": 33071, "wrapT": 33071}],
        "textures": [{"source": 0, "sampler": 0}, {"source": 1}],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.6, 0.7, 1],
                                      "metallicFactor": 0.2}},
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 1}, "emissiveTexture": {"index": 0},
             "emissiveFactor": [0.2, 0.1, 0.0], "alphaMode": "MASK",
             "alphaCutoff": 0.4, "doubleSided": True}],
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.8, "znear": 0.1}}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "spot", "color": [1, 0.9, 0.8], "intensity": 20,
             "spot": {"outerConeAngle": 0.7}}]}},
    }
    path = tmp_path / "tiny.gltf"
    path.write_text(json.dumps(doc))
    return path


def test_load_scene_tiny_gltf_matches_jax(tmp_path):
    """The same glTF through both load_scene: every Scene array equal. The
    JAX loader decodes with PIL and resizes with cv2; the port with its own
    PNG codec, a numpy area filter and torch bilinear. The block encoder
    quantises to 8/5/6 bits, so equal words mean the decoded and
    area-filtered texels agree to well under a quantisation step."""
    path = _write_gltf(tmp_path)
    jh = jloader.load_scene(path, texture_max_dim=64)
    th = tloader.load_scene(path, texture_max_dim=64, device="cpu")
    _compare_scene(th.scene, jh.scene)
    assert th.scene.meta.has_decals and th.scene.meta.has_masked
    assert th.directional_light_index == jh.directional_light_index
    np.testing.assert_array_equal(th.bounds_center, jh.bounds_center)
    assert len(th.cameras) == len(jh.cameras) == 1
    for k in ("position", "right", "up", "look"):
        np.testing.assert_array_equal(th.cameras[0][k], jh.cameras[0][k])


# ---------------------------------------------------------------------------
# Image codec and resampling (the port carries no PIL / OpenCV)
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _png_with_filters(img, filters):
    """Hand-encode an 8-bit PNG whose row r uses filter filters[r % 5]."""
    h, w, c = img.shape
    bpp = c
    raw = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r % len(filters)]
        prev = raw[r - 1] if r else np.zeros(w * c, np.int64)
        row = raw[r]
        enc = np.zeros_like(row)
        for i in range(w * c):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            cc = prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][f]
            enc[i] = (row[i] - pred) & 0xFF
        out += bytes([f]) + enc.astype(np.uint8).tobytes()
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decode_all_filters_matches_pil(channels):
    """All five scanline filters in one image, every colour type the
    content uses; decoded RGBA equal to PIL's, byte for byte."""
    from PIL import Image
    img = np.random.default_rng(channels).integers(
        0, 256, (13, 11, channels), dtype=np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3, 4])
    with Image.open(io.BytesIO(data)) as im:
        ref = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(tpng.decode_png(data), ref)
    assert tpng.png_size(data) == (11, 13)


def test_png_roundtrips_with_pil():
    """PIL-written PNGs (its own filter choice) decode equal; the port's
    encoder writes PNGs that PIL reads back equal."""
    from PIL import Image
    img = np.random.default_rng(9).integers(0, 256, (37, 29, 4),
                                            dtype=np.uint8)
    img[:10] = 17                       # flat rows invite other filters
    np.testing.assert_array_equal(tpng.decode_png(_png_pil(img)), img)
    with Image.open(io.BytesIO(tpng.encode_png(img))) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGBA")), img)


@pytest.mark.parametrize("src,dst", [(64, 16), (64, 32), (24, 64),
                                     (48, 64)])
def test_resize_matches_cv2(src, dst):
    """Integer downscales against cv2.INTER_AREA, upscales against
    cv2.INTER_LINEAR (what the JAX loader calls): 1e-5 absolute, f32
    rounding of the means and lerps."""
    import cv2
    img = np.random.default_rng(src + dst).random((src, src, 4)) \
        .astype(np.float32)
    interp = cv2.INTER_AREA if src > dst else cv2.INTER_LINEAR
    ref = cv2.resize(img, (dst, dst), interpolation=interp)
    np.testing.assert_allclose(ttex._resize_rgba_f32(img, dst), ref,
                               rtol=0, atol=1e-5)


def test_material_stack_samplers_match_jax():
    """The exact-path device samplers on a real block-encoded stack
    (the glTF content path): trilinear 16-channel fetch and the alpha
    mirror, against JAX at 1e-6 absolute (same f32 arithmetic)."""
    rng = np.random.default_rng(11)

    class _G:
        materials = [{"alphaMode": "MASK"}, {}]

    flat = rng.integers(0, 2 ** 32, (21 + 1, 4), dtype=np.uint64) \
        .astype(np.uint32)
    flat[:, 0] |= np.uint32(0xFF000000)
    meta = np.asarray([[0, 4, 3, jtex.ADDRESS_MIRROR],
                       [21, 1, 1, jtex.ADDRESS_WRAP]], np.int32)
    jstack = jtex.make_material_stack(flat, meta)
    tstack = ttex.material_stack(
        {f.name: np.asarray(getattr(jstack, f.name))
         for f in dataclasses.fields(jstack)}, "cpu")
    n = 300
    mat = rng.integers(0, 2, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-0.5, 3.0, n).astype(np.float32)
    j = np.asarray(jtex.sample_material_stack(
        jstack, jnp.asarray(mat), jnp.asarray(uv), lod=jnp.asarray(lod)))
    t = ttex.sample_material_stack(tstack, torch.as_tensor(mat),
                                   torch.as_tensor(uv),
                                   lod=torch.as_tensor(lod)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    ja = np.asarray(jtex.sample_stack_alpha(
        jstack, jnp.asarray(mat), jnp.asarray(uv), lod=jnp.asarray(lod)))
    ta = ttex.sample_stack_alpha(tstack, torch.as_tensor(mat),
                                 torch.as_tensor(uv),
                                 lod=torch.as_tensor(lod)).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-6)
    c = np.random.default_rng(3).random((50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttex.linear_to_srgb(torch.as_tensor(c)).numpy(),
        np.asarray(jtex.linear_to_srgb(jnp.asarray(c))), atol=1e-6)
