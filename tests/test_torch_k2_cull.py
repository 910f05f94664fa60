"""K2's exact-zero skips and z-slice search, on the CPU.

K2 (csrc/clustered.cu) skips the BRDF of a cluster light that the twin
adds as exactly +0.0 at a pixel: beyond its range, outside its spot cone
or behind the surface (clustered.zero_light_tests, in the twin's
arithmetic). It finds a pixel's z slice by a binary search over the slice
bounds (clustered.slice_by_search), and it rounds as the twin does but
for one shared division. Each is held to the twin here."""

import numpy as np
import torch

from incarnation_tpu_torch.config import Config
from incarnation_tpu_torch.kernels import clustered, shading
from incarnation_tpu_torch.scene import lights as lights_mod
from incarnation_tpu_torch.scene import stress

torch.set_num_threads(1)


def _atrium_lights(seed=0):
    """Light rows made by the atrium's recipe (scene/stress.py: per room
    8 points of range 9 at 0.55 of the wall height, 3 downward spots of
    range 14 with cones 0.4 / 0.8 under the ceiling; 66 lights), positions
    drawn from a seed."""
    r = np.random.default_rng(seed)
    defs, xforms = [], []
    for rz in range(stress.ROOMS_Z):
        for rx in range(stress.ROOMS_X):
            x0, z0 = rx * stress.ROOM, rz * stress.ROOM
            for k in range(11):
                xf = np.eye(4, dtype=np.float32)
                lo, span = (0.2, 0.6) if k < 8 else (0.3, 0.4)
                xf[3, 0] = x0 + (lo + span * r.random()) * stress.ROOM
                xf[3, 2] = z0 + (lo + span * r.random()) * stress.ROOM
                if k < 8:
                    xf[3, 1] = stress.WALL_H * 0.55
                    defs.append({"type": "point", "range": 9.0,
                                 "intensity": 8.0 + 10.0 * r.random(),
                                 "color": (0.6 + 0.4 * r.random(3)).tolist()})
                else:
                    # pointing down: the direction toward the light,
                    # -row 2, is +y
                    xf[3, 1] = stress.WALL_H - 0.4
                    xf[1, :3], xf[2, :3] = [0, 0, 1], [0, -1, 0]
                    defs.append({"type": "spot", "range": 14.0,
                                 "intensity": 40.0,
                                 "color": [1.0, 0.95, 0.8],
                                 "spot": {"innerConeAngle": 0.4,
                                          "outerConeAngle": 0.8}})
                xforms.append(xf)
    return lights_mod.light_table(lights_mod.light_arrays(defs, xforms),
                                  "cpu")


def _unit(r, shape):
    v = r.normal(size=shape)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_skipped_lights_add_exactly_zero_in_the_twin():
    """On seeded G-buffer points spread over the atrium's rooms, for every
    light: where a skip test holds, the twin's per-light contribution
    (punctual_light, then brdf_response, as clustered_lighting_dense adds
    it) is exactly +0.0 in every channel. Each test fires somewhere."""
    lights = _atrium_lights()
    r = np.random.default_rng(1)
    n_px = 4096
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    world = f(r.uniform([-2, -1, -2], [38, 7, 26], (n_px, 3)))
    n = f(_unit(r, (n_px, 3)))
    v = _unit(r, (n_px, 3))
    v = f(v * np.sign(np.sum(v * n.numpy(), -1, keepdims=True) + 0.3))
    base = f(r.uniform(0, 1, (n_px, 3)))
    metallic = f(r.uniform(0, 1, n_px))
    rough = f(r.uniform(0.05, 1, n_px))
    fired = np.zeros(3, np.int64)
    for i in range(lights.type.shape[0]):
        tests = clustered.zero_light_tests(lights, i, world, n)
        skip = tests[0] | tests[1] | tests[2]
        l, radiance = shading.punctual_light(
            lights.type[i], lights.transform[i], lights.color[i],
            lights.intensity[i], lights.range[i], lights.spot_angles[i],
            world)
        lit = shading.brdf_response(base, metallic, rough, n, v, l, radiance)
        zero = lit[skip]
        assert bool((zero == 0.0).all()) and not bool(
            torch.signbit(zero).any())
        fired += [int(t.sum()) for t in tests]
    assert (fired > 0).all()


def test_slice_search_equals_pixel_cluster_id():
    """On a seeded depth plane, with depths placed exactly on and one ulp
    around every slice bound: K2's binary search gives
    pixel_cluster_id's z slice at every pixel."""
    cfg = Config()
    gx, gy, gz = clustered.cluster_grid_shape(cfg)
    near, w, h = 0.1, 128, 64
    r = np.random.default_rng(2)
    depth = r.uniform(1e-5, 1.0, (h, w)).astype(np.float32)
    bounds = np.asarray(clustered._slice_bounds(
        near, cfg.cluster_depth_extent, gz), np.float32)
    edge = (np.float32(near) / bounds).astype(np.float32)
    ring = np.concatenate([edge, np.nextafter(edge, 0), np.nextafter(edge, 2),
                           [1e-7, 1.0, 0.0]]).astype(np.float32)
    depth.reshape(-1)[: ring.size] = ring
    depth = torch.tensor(depth)
    view_z = near / torch.clamp(depth, min=1e-6)
    got = clustered.slice_by_search(view_z, torch.tensor(bounds))
    cid = clustered.pixel_cluster_id(depth, cfg, near, w, h)
    torch.testing.assert_close(got, cid // (gx * gy), rtol=0, atol=0)
    assert len(set(got.reshape(-1).tolist())) == gz


def _kernel_emulation(gb, n, v, words, lights):
    """csrc/clustered.cu's per-pixel arithmetic in f32 torch ops, rounded
    as the kernel's (--fmad=false: one rounding per operation): the skips,
    the per-light constants and the one shared division for
    D x G / (4 NoV NoL), lights in ascending order."""
    rows = clustered.light_rows(lights)
    px, py, pz = gb.world_pos.unbind(-1)
    nx, ny, nz = n.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    metal, rough = gb.mrao[..., 0], gb.mrao[..., 1]
    base = gb.base_color[..., :3].unbind(-1)
    f0 = [metal * c + (1.0 - metal) * 0.04 for c in base]
    fd = [(1.0 - metal) * c * np.float32(0.318309886183791) for c in base]
    no_v = torch.clamp(nx * vx + ny * vy + nz * vz, 0.0, 1.0)
    a = rough * rough
    a2 = a * a
    acc = [torch.zeros_like(px) for _ in range(3)]
    for i in range(rows.shape[0]):
        r = rows[i]
        on = (((words[..., i // 32] >> (i % 32)) & 1) > 0) & gb.mask
        lx, ly, lz = r[0] - px, r[1] - py, r[2] - pz
        dist_sq = lx * lx + ly * ly + lz * lz
        dist = torch.sqrt(dist_sq)
        falloff = torch.ones_like(dist)
        if r[8] > 0.0:
            q = dist / torch.clamp(r[8], min=1e-8)
            q2 = q * q
            falloff = torch.clamp(torch.clamp(1.0 - q2 * q2, max=1.0),
                                  min=0.0)
        dl = torch.clamp(dist, min=1e-8)
        ldx, ldy, ldz = lx / dl, ly / dl, lz / dl
        angular = torch.ones_like(dist)
        if r[3] == 2.0:
            cd = r[9] * ldx + r[10] * ldy + r[11] * ldz
            scale = 1.0 / torch.clamp(r[12] - r[13], min=1e-3)
            ang = torch.clamp(cd * scale - r[13] * scale, 0.0, 1.0)
            angular = torch.where(cd > r[13], ang * ang, 0.0)
        no_l = torch.clamp(nx * ldx + ny * ldy + nz * ldz, 0.0, 1.0)
        lit = on & (falloff != 0.0) & (angular != 0.0) & (no_l > 0.0)
        radial = falloff / torch.clamp(dist_sq, min=1e-4)
        hx, hy, hz = ldx + vx, ldy + vy, ldz + vz
        hs = 1.0 / torch.sqrt(hx * hx + hy * hy + hz * hz + 1e-20)
        hx, hy, hz = hx * hs, hy * hs, hz * hs
        no_h = torch.clamp(nx * hx + ny * hy + nz * hz, 0.0, 1.0)
        vo_h = torch.clamp(vx * hx + vy * hy + vz * hz, 0.0, 1.0)
        denom = no_h * no_h * (a2 - 1.0) + 1.0
        x = 1.0 - vo_h
        x2 = x * x
        fw = x2 * x2 * x
        ggx_v = no_l * torch.sqrt(no_v * no_v * (1.0 - a) + a)
        ggx_l = no_v * torch.sqrt(no_l * no_l * (1.0 - a) + a)
        dg = (a2 * 0.5) / (
            torch.clamp(np.float32(3.14159265358979) * denom * denom,
                        min=1e-4)
            * torch.clamp(ggx_v + ggx_l, min=1e-5)
            * torch.clamp(4.0 * no_v * no_l, min=1e-3))
        inten = 10000.0 * r[7]
        for c in range(3):
            fr = fw + f0[c] * (1.0 - fw)
            rad = inten * r[4 + c] * radial * angular
            t = (dg * fr + (1.0 - fr) * fd[c]) * rad * no_l
            acc[c] = acc[c] + torch.where(lit, t, 0.0)
    return torch.stack(acc, -1)


def test_kernel_arithmetic_stays_within_the_twins_tolerance():
    """The kernel's rounding (emulated above) against the twin on a seeded
    G-buffer with glossy surfaces and the atrium's light rows: within
    chip_smoke.py's K2 tolerance, |err| <= 1e-5 |ref| + 1e-5 x the median
    nonzero |ref|."""
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.kernels import resolve
    w, h = 96, 48
    cfg = Config()
    lights = _atrium_lights(seed=3)
    r = np.random.default_rng(4)
    f = lambda x: torch.tensor(np.asarray(x, np.float32))
    view = View.from_lookat([18.0, 3.0, 2.0], [18.0, 2.0, 20.0],
                            aspect=w / h)
    cmask, _ = clustered.build_light_clusters(
        lights, cfg, f(view.projection_transform()),
        f(np.linalg.inv(view.view_proj())), 0.1)
    n = f(_unit(r, (h, w, 3)))
    v = n + 0.9 * f(_unit(r, (h, w, 3)))
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    gb = resolve.GBuffer(
        base_color=f(r.uniform(0, 1, (h, w, 4))),
        normals=f(np.zeros((h, w, 2))),
        mrao=f(r.uniform(0.05, 1, (h, w, 4))),
        emissive=f(np.zeros((h, w, 3))),
        mask=torch.tensor(r.random((h, w)) > 0.1),
        world_pos=f(r.uniform([2, 0, 2], [34, 6, 22], (h, w, 3))),
        uv=f(np.zeros((h, w, 2))), extras=f(np.zeros((h, w, 3))))
    depth = f(r.uniform(0.002, 0.1, (h, w)))
    ref = clustered.clustered_lighting_plain(gb, n, v, depth, lights, cmask,
                                             cfg, 0.1, w, h)
    cid = clustered.pixel_cluster_id(depth, cfg, 0.1, w, h)
    got = _kernel_emulation(gb, n, v, cmask[cid.long()], lights)
    m = gb.mask
    mag = ref[m].abs()
    atol = 1e-5 * float(mag[mag > 0].median())
    assert bool(((got[m] - ref[m]).abs() <= 1e-5 * mag + atol).all())
    assert (mag > 0).float().mean() > 0.25


def test_twin_dots_sum_left_to_right():
    """The twin's 3-vector dot products (mathutils.dot3, in
    shading.brdf_response, punctual_light, normalize and
    zero_light_tests) add (x + y) + z, as K2 does: on rows where the
    other orders round apart, dot3 keeps K2's, whatever order torch.sum
    takes on the device (on the card it adds (x + z) + y)."""
    from incarnation_tpu_torch.core import mathutils as mu
    one = torch.ones(1)
    row = torch.tensor([[1.0, 2.0 ** -24, 2.0 ** -24]])
    # (1 + 2^-24) + 2^-24 rounds to 1 twice; 1 + (2^-24 + 2^-24) does not
    assert float(mu.dot3(row, one)) == 1.0
    r = np.random.default_rng(5)
    a = torch.tensor(r.normal(size=(4096, 3)).astype(np.float32))
    b = torch.tensor(r.normal(size=(4096, 3)).astype(np.float32))
    p = a * b
    left = p[:, 0] + p[:, 1] + p[:, 2]
    assert torch.equal(mu.dot3(a, b), left)
    assert not torch.equal(left, (p[:, 0] + p[:, 2]) + p[:, 1])
    assert torch.equal(mu.dot3(a, b, keepdim=True)[:, 0], left)
    want = a * (1.0 / torch.sqrt(mu.dot3(a, a, keepdim=True) + 1e-20))
    assert torch.equal(mu.normalize(a), want)
