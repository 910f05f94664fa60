"""Preetham analytic sky (port of incarnation_tpu/kernels/sky.py).

Scale conventions are the reference's: the lat-long probe source stores
0.04 x radiance, the raster background evaluates 1000 x radiance."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import mathutils as mu


class PerezCoefficients(NamedTuple):
    a: np.ndarray  # (3,) for Yxy channels
    b: np.ndarray
    c: np.ndarray
    d: np.ndarray
    e: np.ndarray


def perez_coefficients(turbidity: float) -> PerezCoefficients:
    t = float(turbidity)
    return PerezCoefficients(
        a=np.array([0.1787 * t - 1.4630, -0.0193 * t - 0.2592,
                    -0.0167 * t - 0.2608], np.float32),
        b=np.array([-0.3554 * t + 0.4275, -0.0665 * t + 0.0008,
                    -0.0950 * t + 0.0092], np.float32),
        c=np.array([-0.0227 * t + 5.3251, -0.0004 * t + 0.2125,
                    -0.0079 * t + 0.2102], np.float32),
        d=np.array([0.1206 * t - 2.5771, -0.0641 * t - 0.8989,
                    -0.0441 * t - 1.6537], np.float32),
        e=np.array([-0.0670 * t + 0.3703, -0.0033 * t + 0.0452,
                    -0.0109 * t + 0.0529], np.float32),
    )


@functools.lru_cache(maxsize=16)
def _perez_on(turbidity: float, device) -> PerezCoefficients:
    """perez_coefficients as (3,) f32 tensors on `device`, made once per
    key: a copy from host memory waits for the stream, and each call of
    sky_radiance would make ten."""
    return PerezCoefficients(*(torch.as_tensor(x, device=device)
                               for x in perez_coefficients(turbidity)))


def _perez(theta, gamma, pc: PerezCoefficients):
    """pc: _perez_on's tensors on theta's device."""
    t = theta[..., None]
    g = gamma[..., None]
    cos_t = torch.clamp(torch.cos(t), min=1e-5)
    return ((1.0 + pc.a * torch.exp(pc.b / cos_t))
            * (1.0 + pc.c * torch.exp(pc.d * g)
               + pc.e * torch.cos(g) * torch.cos(g)))


def _zenith_yxy(t: float, theta_s):
    chi = (4.0 / 9.0 - t / 120.0) * (mu.PI - 2.0 * theta_s)
    y_lum = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192
    # the powers as products (XLA's integer_pow multiplies so), which K12
    # (csrc/skylight.cu) repeats
    th = theta_s
    th2 = th * th
    th3 = th2 * th
    x_z = ((0.00165 * th3 - 0.00375 * th2 + 0.00209 * th) * t * t
           + (-0.02903 * th3 + 0.06377 * th2 - 0.03202 * th + 0.00394) * t
           + (0.11693 * th3 - 0.21196 * th2 + 0.06052 * th + 0.25886))
    y_z = ((0.00275 * th3 - 0.00610 * th2 + 0.00317 * th) * t * t
           + (-0.04214 * th3 + 0.08970 * th2 - 0.04153 * th + 0.00516) * t
           + (0.15346 * th3 - 0.26756 * th2 + 0.06670 * th + 0.26688))
    return torch.stack([y_lum, x_z, y_z], dim=-1)


_XYZ2RGB = np.array([
    [3.2404542, -0.9692660, 0.0556434],
    [-1.5371385, 1.8760108, -0.2040259],
    [-0.4985314, 0.0415560, 1.0572252]], np.float32)


@functools.lru_cache(maxsize=16)
def _xyz2rgb_on(device):
    """_XYZ2RGB as an f32 tensor on `device`, made once per device."""
    return torch.as_tensor(_XYZ2RGB, device=device)


def _yxy_to_rgb(yxy):
    y_lum = yxy[..., 0]
    x = yxy[..., 1]
    y = torch.clamp(yxy[..., 2], min=1e-6)
    big_x = x * (y_lum / y)
    big_z = (1.0 - x - y) * (y_lum / y)
    xyz = torch.stack([big_x, y_lum, big_z], dim=-1)
    return mu.rows_mat(xyz, _xyz2rgb_on(yxy.device))


def sky_radiance(sun_dir, directions, turbidity: float):
    """Preetham radiance for unit `directions` (..., 3), unscaled.
    sun_dir: (3,) tensor on the directions' device. The dot product and
    the XYZ -> RGB product sum left to right (mathutils.dot3, rows_mat):
    K12 (csrc/skylight.cu) repeats every operation in this order."""
    pc = _perez_on(float(turbidity), directions.device)
    theta_s = torch.arccos(torch.clamp(sun_dir[1], 0.0, 1.0))
    theta_e = torch.arccos(torch.clamp(directions[..., 1], 0.0, 1.0))
    gamma_e = torch.arccos(torch.clamp(mu.dot3(directions, sun_dir), 0.0,
                                       1.0))
    yxy_zenith = _zenith_yxy(turbidity, theta_s)
    f = _perez(theta_e, gamma_e, pc)
    f0 = _perez(torch.zeros_like(theta_s), theta_s, pc)
    return _yxy_to_rgb(yxy_zenith * (f / f0))


def sky_latlong(sun_dir, turbidity: float, width: int, height: int,
                scale: float = 0.04):
    """Dynamic-sky lat-long texture (height, width, 3) = scale x radiance."""
    dev = sun_dir.device
    us = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    vs = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) \
        / height
    uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), dim=-1)
    dirs = mu.latlong_uv_to_direction(uv)
    return scale * sky_radiance(sun_dir, dirs, turbidity)
