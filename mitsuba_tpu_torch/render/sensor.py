"""Sensors (port of ``mitsuba_tpu/render/sensor.py``): the perspective,
thin-lens, orthographic, spherical, telecentric and radially distorted
cameras, and the radiance, irradiance and fluence meters.

A sensor is a NamedTuple of camera constants: float32 tensors on the render
device, and the type tag as a Python int, so that ``sample_ray`` computes
the branch of that type alone, with no device round trip. Each branch keeps
the JAX package's arithmetic; the meters carry a constant estimator weight
(``ray_weight``) that turns a cosine- or sphere-sampled radiance mean into
irradiance or fluence. ``sample_direct``, ``pdf_ray_direction`` and
``camera_pdf_area`` connect the particle tracer's and the bidirectional
tracer's light vertices to the camera.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import math as m
from ..core import warp
from ..core.transform import Transform
from ..device import resolve_device

PERSPECTIVE = 0
THINLENS = 1
ORTHOGRAPHIC = 2
SPHERICAL = 3
RADIANCEMETER = 4
IRRADIANCEMETER = 5
TELECENTRIC = 6
PERSPECTIVE_RDIST = 7
FLUENCEMETER = 8
TYPES = tuple(range(9))
METERS = (RADIANCEMETER, IRRADIANCEMETER, FLUENCEMETER)


class Sensor(NamedTuple):
    type: int                      # sensor type tag
    to_world: torch.Tensor         # (4, 4) camera-to-world
    tan_half_fov: torch.Tensor     # () tan(fov_x / 2)
    aspect: torch.Tensor           # () width / height
    aperture_radius: torch.Tensor  # () thinlens, telecentric, irradiancemeter
    focus_distance: torch.Tensor   # ()
    ortho_scale: torch.Tensor      # (2,) orthographic half-extents
    near: torch.Tensor             # ()
    rdist: torch.Tensor            # (2,) radial distortion (kc0, kc1)

    @property
    def position(self):
        return self.to_world[:3, 3]


def _sensor(stype, to_world, tan_half_fov, aspect, aperture_radius=0.0,
            focus_distance=1.0, ortho_scale=(1.0, 1.0), near=0.0,
            rdist=(0.0, 0.0), device=None) -> Sensor:
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Sensor(
        type=stype, to_world=f32(to_world.m), tan_half_fov=f32(tan_half_fov),
        aspect=f32(aspect), aperture_radius=f32(aperture_radius),
        focus_distance=f32(focus_distance), ortho_scale=f32(ortho_scale),
        near=f32(near), rdist=f32(rdist))


def make_perspective(to_world: Transform, fov_deg: float, width: int,
                     height: int, fov_axis: str = "x", near: float = 1e-2,
                     device=None) -> Sensor:
    """``fov_deg`` spans the image axis ``fov_axis`` (perspective.cpp:
    x, y, smaller, larger or diagonal)."""
    aspect = width / height
    t = np.tan(np.deg2rad(fov_deg) / 2.0)
    if fov_axis == "y":
        t = t * aspect
    elif fov_axis == "smaller":
        if aspect < 1.0:
            t = t * aspect
    elif fov_axis == "larger":
        if aspect > 1.0:
            t = t * aspect
    elif fov_axis == "diagonal":
        t = t / np.hypot(1.0, 1.0 / aspect)
    return _sensor(PERSPECTIVE, to_world, t, aspect, near=near,
                   device=device)


def make_thinlens(to_world: Transform, fov_deg: float, width: int,
                  height: int, aperture_radius: float, focus_distance: float,
                  fov_axis: str = "x", device=None) -> Sensor:
    """thinlens.cpp: the perspective camera with its rays leaving a disk of
    ``aperture_radius``, focused at ``focus_distance`` along the axis."""
    return make_perspective(to_world, fov_deg, width, height, fov_axis,
                            device=device)._replace(
        type=THINLENS, aperture_radius=_like(aperture_radius, device),
        focus_distance=_like(focus_distance, device))


def _like(x, device):
    return torch.as_tensor(np.float32(x), device=resolve_device(device))


def make_orthographic(to_world: Transform, width: int, height: int,
                      device=None) -> Sensor:
    """orthographic.cpp: parallel rays from the film; the extent comes from
    ``to_world``'s scaling."""
    aspect = width / height
    return _sensor(ORTHOGRAPHIC, to_world, 1.0, aspect,
                   ortho_scale=(1.0, 1.0 / aspect), device=device)


def make_spherical(to_world: Transform, device=None) -> Sensor:
    """spherical.cpp: a lat-long image of every direction."""
    return _sensor(SPHERICAL, to_world, 1.0, 1.0, device=device)


def _frame_along(origin, direction):
    d = np.asarray(direction, float)
    d = d / np.linalg.norm(d)
    up = (np.array([0.0, 1.0, 0.0]) if abs(d[1]) < 0.99
          else np.array([1.0, 0.0, 0.0]))
    return Transform.look_at(origin, np.asarray(origin) + d, up)


def make_radiancemeter(origin, direction, device=None) -> Sensor:
    """radiancemeter.cpp: the radiance arriving at ``origin`` from
    ``direction``'s opposite, along one ray."""
    return make_spherical(_frame_along(origin, direction),
                          device=device)._replace(type=RADIANCEMETER)


def make_telecentric(to_world: Transform, width: int, height: int,
                     aperture_radius: float = 0.0,
                     focus_distance: float = 1.0, device=None) -> Sensor:
    """telecentric.cpp: parallel projection with a finite aperture
    (orthographic depth of field)."""
    return make_orthographic(to_world, width, height, device=device)._replace(
        type=TELECENTRIC, aperture_radius=_like(aperture_radius, device),
        focus_distance=_like(focus_distance, device))


def make_perspective_rdist(to_world: Transform, fov_deg: float, width: int,
                           height: int, kc=(0.0, 0.0), fov_axis: str = "x",
                           device=None) -> Sensor:
    """perspective_rdist.cpp: the perspective camera with polynomial radial
    distortion r' = r (1 + kc0 r^2 + kc1 r^4) on the image plane."""
    return make_perspective(to_world, fov_deg, width, height, fov_axis,
                            device=device)._replace(
        type=PERSPECTIVE_RDIST,
        rdist=torch.as_tensor(np.asarray(kc, np.float32),
                              device=resolve_device(device)))


def make_irradiancemeter(origin, normal, radius: float = 0.0,
                         device=None) -> Sensor:
    """irradiancemeter.cpp: cosine-weighted directions over the hemisphere
    of ``normal``, from a disk of ``radius`` (0: a point); the film's mean
    times ``ray_weight`` is the irradiance."""
    return make_spherical(_frame_along(origin, normal),
                          device=device)._replace(
        type=IRRADIANCEMETER, aperture_radius=_like(radius, device))


def make_fluencemeter(origin, device=None) -> Sensor:
    """fluencemeter.cpp: uniform directions over the sphere from a point;
    the film's mean times ``ray_weight`` is the fluence."""
    t = Transform.look_at(origin, np.asarray(origin, float) + [0.0, 0.0, 1.0],
                          [0.0, 1.0, 0.0])
    return make_spherical(t, device=device)._replace(type=FLUENCEMETER)


def ray_weight(sensor: Sensor) -> float:
    """The constant weight W that turns the film's mean into the
    measurement: pi for the cosine-sampled irradiance meter, 4 pi for the
    sphere-sampled fluence meter, 1 for the others (float32 values, as the
    JAX package's)."""
    if sensor.type == IRRADIANCEMETER:
        return float(np.float32(math.pi))
    if sensor.type == FLUENCEMETER:
        return float(np.float32(4.0 * math.pi))
    return 1.0


def pixel_spread(sensor: Sensor, width: int):
    """Angular size of one pixel at the image center (radians)."""
    return 2.0 * sensor.tan_half_fov / float(np.float32(width))


def _stack0(a, b):
    """(a, b, 0) as (R, 3)."""
    return torch.stack([a, b, torch.zeros_like(a)], dim=-1)


def sample_ray(sensor: Sensor, uv, u_aperture):
    """Film positions uv in [0,1)^2 (R, 2) and aperture draws (R, 2) ->
    world rays (o, d), (R, 3) each, contiguous as the intersectors require.
    Only the branch of the sensor's type is computed, in the JAX package's
    order of operations; the meters read ``uv`` as their direction draw."""
    st = sensor.type
    if st not in TYPES:
        raise ValueError(f"unknown sensor type {st}")
    A = sensor.to_world
    o_cam = None  # the origin: None for the sensor's position
    if st in (PERSPECTIVE, THINLENS, PERSPECTIVE_RDIST):
        x = (2.0 * uv[..., 0] - 1.0) * sensor.tan_half_fov
        y = (1.0 - 2.0 * uv[..., 1]) * sensor.tan_half_fov / sensor.aspect
        if st == PERSPECTIVE_RDIST:
            # polynomial radial distortion of the image-plane point
            r2 = x * x + y * y
            f = 1.0 + sensor.rdist[0] * r2 + sensor.rdist[1] * r2 * r2
            x, y = x * f, y * f
        d_cam = m.normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))
        if st == THINLENS:
            # the origin on the aperture disk, refocused on the plane at
            # focus_distance
            lens = warp.square_to_uniform_disk_concentric(u_aperture) \
                * sensor.aperture_radius
            focus_t = sensor.focus_distance / torch.clamp(d_cam[..., 2],
                                                          min=1e-6)
            p_focus = d_cam * focus_t[..., None]
            o_cam = _stack0(lens[..., 0], lens[..., 1])
            d_cam = m.normalize(p_focus - o_cam)
    elif st in (ORTHOGRAPHIC, TELECENTRIC):
        o_cam = _stack0((2.0 * uv[..., 0] - 1.0) * sensor.ortho_scale[0],
                        (1.0 - 2.0 * uv[..., 1]) * sensor.ortho_scale[1])
        if st == ORTHOGRAPHIC:
            d_cam = torch.tensor([0.0, 0.0, 1.0],
                                 device=uv.device).expand(o_cam.shape)
        else:
            # the aperture disk about the film point, refocused at
            # z = focus_distance
            lens = warp.square_to_uniform_disk_concentric(u_aperture) \
                * sensor.aperture_radius
            p_focus = o_cam + torch.stack(
                [torch.zeros_like(lens[..., 0]), torch.zeros_like(lens[..., 0]),
                 sensor.focus_distance.expand(lens.shape[:-1])], dim=-1)
            o_cam = o_cam + _stack0(lens[..., 0], lens[..., 1])
            d_cam = m.normalize(p_focus - o_cam)
    elif st == IRRADIANCEMETER:
        disk = warp.square_to_uniform_disk_concentric(u_aperture) \
            * sensor.aperture_radius
        o_cam = _stack0(disk[..., 0], disk[..., 1])
        d_cam = warp.square_to_cosine_hemisphere(uv)
    elif st == FLUENCEMETER:
        d_cam = warp.square_to_uniform_sphere(uv)
    elif st == SPHERICAL:
        # lat-long over the whole sphere; at the poles sin(theta) = 0
        theta = uv[..., 1] * math.pi
        phi = uv[..., 0] * 2.0 * math.pi - math.pi
        sin_t = torch.sin(theta)
        d_cam = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                             -sin_t * torch.cos(phi)], dim=-1)
    else:  # RADIANCEMETER: one direction, +z
        d_cam = torch.tensor([0.0, 0.0, 1.0],
                             device=uv.device).expand(uv.shape[:-1] + (3,))
    if o_cam is None:
        # every ray leaves the sensor's position
        o_w = A[:3, 3].expand(d_cam.shape).contiguous()
    else:
        o_w = o_cam @ A[:3, :3].T + A[:3, 3]
    return o_w, m.normalize(d_cam @ A[:3, :3].T)


# --- camera connections (sensor.h sampleDirect, pdfDirection) --------------

class SensorSample(NamedTuple):
    """A world point's connection to the camera (PerspectiveCamera::
    sampleDirect). ``imp`` is the importance 1 / (A_plane cos^3 r^2) of a
    pinhole, 1 / A_film of the orthographic camera: a light vertex of power
    beta splats beta f imp at film position ``uv``."""

    d: torch.Tensor      # (R, 3) unit direction from the point to the sensor
    dist: torch.Tensor   # (R,)
    uv: torch.Tensor     # (R, 2) film position in [0, 1)^2
    imp: torch.Tensor    # (R,) importance, 0 where not valid
    valid: torch.Tensor  # (R,) inside the frustum and in front


def image_plane_area(sensor: Sensor):
    """Area of the virtual image plane at z = 1 (perspective)."""
    t = sensor.tan_half_fov
    return 4.0 * t * t / sensor.aspect


def _film_uv(sensor: Sensor, d_cam):
    """(u, v, z clamped to 1e-6, in front and inside) of camera-space
    directions d_cam through the pinhole's image plane."""
    z = d_cam[..., 2]
    in_front = z > 1e-6
    zs = torch.clamp(z, min=1e-6)
    x_pl = d_cam[..., 0] / zs
    y_pl = d_cam[..., 1] / zs
    u = (x_pl / sensor.tan_half_fov + 1.0) * 0.5
    v = (1.0 - y_pl * sensor.aspect / sensor.tan_half_fov) * 0.5
    inside = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    return u, v, zs, in_front & inside


def sample_direct(sensor: Sensor, p) -> SensorSample:
    """Connect world points p (R, 3) to the sensor. Perspective, and a thin
    lens as a pinhole, connect to the aperture point (perspective.cpp
    sampleDirect); the orthographic camera along its view direction to the
    film plane's projection (orthographic.cpp:235-264: a discrete
    direction, importance 1 / A_film, no falloff). Every other type,
    telecentric among them (telecentric.cpp sampleDirect refuses), is never
    valid: the pinhole's values with ``valid`` False, as in the JAX
    package."""
    A = sensor.to_world
    if sensor.type == ORTHOGRAPHIC:
        xo, yo, zo, in_front, view, a_world = _ortho_film(sensor, p)
        uo = (xo + 1.0) * 0.5
        vo = (1.0 - yo) * 0.5
        valid = (uo >= 0.0) & (uo < 1.0) & (vo >= 0.0) & (vo < 1.0) & in_front
        imp = m.safe_div(torch.ones((), device=p.device), a_world)
        # dist: the world distance from p to its film projection
        return SensorSample(d=(-view).expand(p.shape).contiguous(),
                            dist=zo * m.length(A[:3, 2]),
                            uv=torch.stack([uo, vo], dim=-1),
                            imp=torch.where(valid, imp, 0.0), valid=valid)
    to_cam = A[:3, 3] - p
    dist = m.length(to_cam)
    d = to_cam / torch.clamp(dist, min=1e-12)[..., None]
    # world -> camera rotation (a rigid to_world, as in the reference)
    u, v, zs, valid = _film_uv(sensor, (-d) @ A[:3, :3])
    cos3 = zs * zs * zs  # z = cos(theta) of a unit d_cam
    imp = m.safe_div(torch.ones((), device=p.device),
                     image_plane_area(sensor) * cos3
                     * torch.clamp(dist * dist, min=1e-12))
    valid = valid & (sensor.type in (PERSPECTIVE, THINLENS))
    return SensorSample(d=d, dist=dist, uv=torch.stack([u, v], dim=-1),
                        imp=torch.where(valid, imp, 0.0), valid=valid)


def _ortho_film(sensor: Sensor, p):
    """The orthographic projection of points p: (film x and y in [-1, 1],
    camera-space depth, beyond the near plane, world view direction, world
    film area); to_world may carry the extent as its scale."""
    A = sensor.to_world
    A_inv = torch.linalg.inv(A)
    local = p @ A_inv[:3, :3].T + A_inv[:3, 3]
    a1 = A[:3, 0] * sensor.ortho_scale[0]
    a2 = A[:3, 1] * sensor.ortho_scale[1]
    return (local[..., 0] / sensor.ortho_scale[0],
            local[..., 1] / sensor.ortho_scale[1], local[..., 2],
            local[..., 2] > torch.clamp(sensor.near, min=1e-6),
            m.normalize(A[:3, 2]), 4.0 * m.length(m.cross(a1, a2)))


def pdf_ray_direction(sensor: Sensor, d_world):
    """Solid-angle pdf of a camera ray leaving along ``d_world`` under
    uniform film sampling: 1 / (A_plane cos^3 theta), 0 outside the frustum
    (perspective.cpp pdfDirection)."""
    _, _, zs, ok = _film_uv(sensor, d_world @ sensor.to_world[:3, :3])
    pdf = m.safe_div(torch.ones((), device=d_world.device),
                     image_plane_area(sensor) * zs * zs * zs)
    return torch.where(ok, pdf, 0.0)


def camera_pdf_area(sensor: Sensor, p, n_target):
    """Area density of the camera generating a first vertex at ``p`` with
    normal ``n_target`` (a zero normal: a volume vertex, cos := 1), which the
    bidirectional MIS walk compares the t = 0 and t = 1 strategies with: the
    directional pdf times cos / d^2 for a pinhole, the parallel projection's
    film density |cos| / A_world for the orthographic camera."""
    is_vol = m.squared_length(n_target) < 0.5
    if sensor.type == ORTHOGRAPHIC:
        xo, yo, _, in_front, view, a_world = _ortho_film(sensor, p)
        inside = (torch.abs(xo) < 1.0) & (torch.abs(yo) < 1.0) & in_front
        cos_o = torch.where(is_vol, 1.0, torch.abs(m.dot(n_target, view)))
        return torch.where(inside, m.safe_div(cos_o, a_world), 0.0)
    to_p = p - sensor.position
    dist2 = torch.clamp(m.squared_length(to_p), min=1e-12)
    d = to_p / torch.sqrt(dist2)[..., None]
    cos_t = torch.where(is_vol, 1.0, torch.abs(m.dot(n_target, d)))
    return pdf_ray_direction(sensor, d) * m.safe_div(cos_t, dist2)
