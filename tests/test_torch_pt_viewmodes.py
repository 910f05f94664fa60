"""Port parity for the path tracer's primary-hit view modes (2 roughness,
3 metallic, 4 base colour, 5 emissive) on make_rich_scene, whose cutout
screen peels some primary rays, at 32x16 (one JAX compile of the four
modes), and for the material fetch the path tracer uses: one jittered
texel of mip 0 (textures._stack_point), on a random 8x8 texture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import bvh as jbvh
from incarnation_tpu.kernels import pathtrace as jpt
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu.scene import textures as jtex
from incarnation_tpu.scene.testing import make_rich_scene
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import bvh as tbvh
from incarnation_tpu_torch.kernels import pathtrace as tpt
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader
from incarnation_tpu_torch.scene import textures as ttex

torch.set_num_threads(1)

W, H = 32, 16
MODES = (2, 3, 4, 5)
EYE, TARGET = [0.5, 1.5, -1.0], [0.0, -1.0, 7.0]


def test_primary_view_modes_match_jax():
    """Each mode's image agrees with JAX's on >= 99% of the pixels to
    1e-5 (the material at the same hit and the same jittered texel); the
    few others are rays on a shared edge."""
    js = make_rich_scene()
    mp = np.array(js.mat_params)
    mp[:, 0:3] = [[0.3, 0.2, 0.1], [0.05, 0.1, 0.2]]    # emissive factors
    mp[:, 3:6] = [[0.8, 0.5, 0.3], [0.2, 0.6, 0.9]]     # base colour
    mp[:, 7] = [0.25, 0.75]                             # metallic
    mp[:, 8] = [0.6, 0.35]                              # roughness
    js = dataclasses.replace(js, mat_params=jnp.asarray(mp))
    ts = tloader.scene_from_arrays(*tloader.scene_arrays(js), "cpu")
    jb = jbvh.build_scene_bvh(js, use_cache=False)
    tb = tbvh.build_scene_bvh(ts, use_cache=False, device="cpu")
    jfc = jframe.FrameConstants.make(
        JView.from_lookat(EYE, TARGET, aspect=W / H), JConfig())
    tfc = tframe.FrameConstants.make(
        TView.from_lookat(EYE, TARGET, aspect=W / H), TConfig(),
        device="cpu")

    @jax.jit
    def jax_modes(scene, bvh, fc):
        sb, fb, wn, wt = jframe.pathtrace_inputs(scene, fc)
        return [jpt.trace_sample(sb, bvh, wn, wt, fb, None, jnp.uint32(7),
                                 W, H, sqrt_sample_count=4, viewmode=m)
                for m in MODES]

    jimgs = jax_modes(js, jb, jfc)
    sb, fb, wn, wt = tframe.pathtrace_inputs(ts, tfc)
    for m, jimg in zip(MODES, jimgs):
        t = tpt.trace_sample(sb, tb, wn, wt, fb, None, 7, W, H,
                             sqrt_sample_count=4, viewmode=m).numpy()
        j = np.asarray(jimg)
        ok = np.isclose(t, j, rtol=1e-5, atol=1e-6).all(-1)
        assert ok.mean() >= 0.99, (m, ok.mean())
        assert (t > 0).any(-1).mean() > 0.5          # geometry in view


def test_jittered_mip0_fetch_matches_jax():
    """sample_material_stack(lod=None, jitter=...) on a random 8x8 RGBA
    texture (wrap, clamp and mirror addressing): the same texel, decoded
    identically."""
    rng = np.random.default_rng(0)
    size = 8
    flat = rng.integers(0, 2**32, (3 * size * size, 4),
                        dtype=np.uint64).astype(np.uint32)
    meta = np.asarray([[i * size * size, size, 1, i] for i in range(3)],
                      np.int32)
    jstack = jtex.make_material_stack(flat, meta)
    arrays = {f.name: np.asarray(getattr(jstack, f.name))
              for f in dataclasses.fields(jstack)}
    tstack = ttex.material_stack(arrays, "cpu")
    n = 3000
    mat = rng.integers(0, 3, n).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    jit = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    j = np.asarray(jtex.sample_material_stack(
        jstack, jnp.asarray(mat), jnp.asarray(uv), lod=None,
        jitter=jnp.asarray(jit)))
    t = ttex.sample_material_stack(tstack, torch.tensor(mat),
                                   torch.tensor(uv), lod=None,
                                   jitter=torch.tensor(jit)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)

