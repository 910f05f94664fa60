"""The light-cluster grid and the sky background against the JAX package
on the CPU: K11's twin (clustered.build_light_clusters on CPU tensors)
word for word and count for count, K12's twin
(skylight.environment_background on CPU tensors) at the JAX comparison's
tolerance, on the inputs the card tests give K11 and K12
(tests/test_torch_kernels_cuda.py light_grid_inputs, background_inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.kernels import clustered as jcl
from incarnation_tpu.kernels import skylight as jsl
from incarnation_tpu.scene import lights as jlights
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.kernels import clustered as tcl
from incarnation_tpu_torch.kernels import sky as tsky
from incarnation_tpu_torch.kernels import skylight as tsl
from incarnation_tpu_torch.scene import lights as tlights
from test_torch_kernels_cuda import background_inputs, light_grid_inputs

torch.set_num_threads(1)


def test_light_grid_matches_jax_exactly():
    """The full 16 x 9 x 24 grid at a 1920:1088 camera, 66 lights and 5
    padding rows: every word and the culled count equal JAX's. Range-0
    lights (MAX_LIGHT_RANGE) are set in some clusters; directional lights
    and the padding rows, point lights inside the frustum, in none."""
    inp = light_grid_inputs(66, seed=0)
    a = inp["arrays"]
    jl = jlights.LightTable(
        **{k: jnp.asarray(a[k]) for k in ("type", "color", "intensity",
                                           "range", "spot_angles",
                                           "transform")},
        count=jnp.asarray(np.int32(a["count"])))
    tl = tlights.light_table(a, "cpu")
    jm, jc = jcl.build_light_clusters(jl, JConfig(),
                                      jnp.asarray(inp["proj"]),
                                      jnp.asarray(inp["inv_view_proj"]), 1.0)
    tm, tc = tcl.build_light_clusters(
        tl, TConfig(), torch.as_tensor(inp["proj"]),
        torch.as_tensor(inp["inv_view_proj"]), 1.0)
    assert tm.shape == (16 * 9 * 24, 3) and tm.dtype == torch.int32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tc) == int(jc)
    bits = (tm.numpy().view(np.uint32)[:, :, None]
            >> np.arange(32, dtype=np.uint32)) & 1
    on = bits.reshape(tm.shape[0], -1)[:, :a["type"].shape[0]].any(0)
    ranged0 = (a["range"] == 0) & (a["type"] != tlights.LIGHT_DIRECTIONAL)
    assert on[:66][ranged0[:66]].any()
    assert not on[a["type"] == tlights.LIGHT_DIRECTIONAL].any()
    assert not on[66:].any()
    assert 0 < int(tc) < 66 * tm.shape[0]


@pytest.mark.parametrize("sun_y", [0.9, 0.08, -0.3],
                         ids=["high", "low", "below_horizon"])
def test_sky_background_matches_jax(sun_y):
    """The dynamic-sky background over a partly covered frame, the sun
    high, low and below the horizon (acos's clamp): 1e-5 relative, 1e-4
    absolute, the tolerance of test_torch_lighting.py's comparison; +0.0
    where covered."""
    w, h = 64, 40
    inp = background_inputs(sun_y, seed=3, width=w, height=h)
    j = np.asarray(jsl.environment_background(
        jnp.asarray(inp["mask"]), jnp.asarray(inp["eye"]),
        jnp.asarray(inp["inv_view_proj"]), w, h,
        sun_dir=jnp.asarray(inp["sun_dir"]), dynamic_sky=True))
    t = tsl.environment_background(
        torch.as_tensor(inp["mask"]), torch.as_tensor(inp["eye"]),
        torch.as_tensor(inp["inv_view_proj"]), w, h,
        sun_dir=torch.as_tensor(inp["sun_dir"]), dynamic_sky=True).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-4)
    mask = inp["mask"]
    assert 0.5 < mask.mean() < 0.95
    assert (t[mask] == 0).all() and not np.signbit(t[mask]).any()
    assert np.isfinite(t).all() and (t[~mask] > 0).all()


def test_sky_constants_made_once_per_turbidity_and_device():
    """The Perez coefficients and the XYZ -> RGB matrix are tensors made
    once per (turbidity, device), equal to the float32 host tables."""
    tsky._perez_on.cache_clear()
    tsky._xyz2rgb_on.cache_clear()
    d = torch.as_tensor(background_inputs(0.5)["sun_dir"])
    dirs = torch.nn.functional.normalize(torch.randn(50, 3), dim=-1)
    for _ in range(3):
        tsky.sky_radiance(d, dirs, 2.0)
    tsky.sky_radiance(d, dirs, 3.0)
    assert tsky._perez_on.cache_info().misses == 2
    assert tsky._xyz2rgb_on.cache_info().misses == 1
    for got, want in zip(tsky._perez_on(2.0, dirs.device),
                         tsky.perez_coefficients(2.0)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsky._xyz2rgb_on(dirs.device).numpy(),
                                  tsky._XYZ2RGB)
