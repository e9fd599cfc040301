"""Debug light views (twin of volumerenderer_tpu.render.debug_views): the
reference's unused helpers ``intersectPointLights`` / ``intersectRayLights``
(common_functions.h:159-180), which render the virtual light set itself
instead of the volume, to inspect what the photon walk produced.

Both take a LightArray's first frame: ``Renderer.lights`` holds the last
frame a step rendered, as a one-frame array.
"""

from __future__ import annotations

import torch

from ..engine.params import RenderParams, StaticConfig
from ..ops import camera, intersect
from .photon import LightArray

# Camera rays x lights tested at once.
_CHUNK = 1 << 24


def _view_lights(params, lights: LightArray, config, hit_fn):
    """(H, W) f32: 1 where ``hit_fn(o, d, light_index)`` holds for a valid
    light of the first frame, else 0.  Only the valid slots are tested
    (one host read); an invalid slot never lights a pixel."""
    H, W = config.height, config.width
    dev = lights.valid.device
    o, d = camera.camera_rays(W, H, params.fov, params.camera_pos,
                              device=dev)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    idx = torch.nonzero(lights.valid[0]).reshape(-1)
    lit = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    step = max(1, _CHUNK // max(o.shape[0], 1))
    for a in range(0, idx.shape[0], step):
        hits, _t = hit_fn(o[None], d[None], idx[a:a + step, None])
        lit |= torch.any(hits, dim=0)
    return lit.to(torch.float32).reshape(H, W)


def view_point_lights(params: RenderParams, lights: LightArray,
                      config: StaticConfig, radius: float = 0.2):
    """White where the camera ray hits a light's scatter point
    (``pos_to``) as a sphere of ``radius`` (common_functions.h:159-168).
    Returns (H, W) f32."""
    centers = lights.pos_to[0]
    return _view_lights(params, lights, config, lambda o, d, i: (
        intersect.intersect_sphere(o, d, centers[i], radius)))


def view_ray_lights(params: RenderParams, lights: LightArray,
                    config: StaticConfig, width: float = 0.1):
    """White where the camera ray passes within ``width`` of a light
    segment (common_functions.h:170-180), with the reference's quirk: the
    segment's END POINT is passed where a direction is expected
    (common_functions.h:175).  Returns (H, W) f32."""
    p_from, p_to = lights.pos_from[0], lights.pos_to[0]
    return _view_lights(params, lights, config, lambda o, d, i: (
        intersect.intersect_thick_ray(o, d, p_from[i], p_to[i], width)))
