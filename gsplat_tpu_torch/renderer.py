"""High-level render entry (port of gsplat_tpu/renderer.py: ``render``).

Renders a GaussianState through the rasterizer with the settings the
caller passes (the inference path, or the training path when
``settings.inference`` is False), and returns the same bundle as the JAX
``render``. The reference's python-side SH / covariance switches and
``deformable_render`` are not ported yet.
"""

from __future__ import annotations

from gsplat_tpu_torch.core.camera import CameraParams
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings, rasterize


def render(camera: CameraParams, state: GaussianState, bg,
           settings: RasterizeSettings, sh_degree: int | None = None,
           scale_modifier: float = 1.0):
    """Render ``state`` from ``camera``; ``sh_degree`` defaults to the
    model's max."""
    deg = state.max_sh_degree if sh_degree is None else sh_degree
    out = rasterize(
        state.xyz, state.get_scaling(), state.get_rotation(),
        state.get_opacity()[:, 0], state.get_features(), camera, deg, bg,
        settings, scale_modifier=scale_modifier, alive=state.alive_mask)
    return {
        "render": out.image,
        "viewspace_points": None,
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "is_used": out.is_used,
        "used_tile": out.used_tile,
        "num_dup": out.num_dup,
        "final_t": out.final_t,
    }
