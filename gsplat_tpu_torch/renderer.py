"""High-level render entries (port of gsplat_tpu/renderer.py).

``render`` draws a GaussianState, ``deformable_render`` a SwinState at a
frame, through the rasterizer with the settings the caller passes (the
inference path, or the training path when ``settings.inference`` is
False); both return the same bundle as their JAX counterparts. The
reference's python-side SH / covariance switches are not ported yet.
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


def deformable_render(camera: CameraParams, state, frame: float, bg,
                      settings: RasterizeSettings,
                      sh_degree: int | None = None):
    """Frame-indexed render of a SwinState (the reference
    deformable_render, gaussian_renderer/__init__.py:105-172): the rigid
    deformation applied by age, the union's active set rendered; returns
    the active-set parameters too (``input_gaussians``, which the
    regularisers read)."""
    from gsplat_tpu_torch.model import swin as swin_lib

    deg = state.im.max_sh_degree if sh_degree is None else sh_degree
    kw = swin_lib.union_params_at(state, frame)
    out = rasterize(kw["means3d"], kw["scales"], kw["quats"],
                    kw["opacities"], kw["shs"], camera, deg, bg, settings,
                    alive=kw["alive"])
    return {
        "render": out.image,
        "viewspace_points": None,
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "is_used": out.is_used,
        "used_tile": out.used_tile,
        "num_dup": out.num_dup,
        "final_t": out.final_t,
        "input_gaussians": kw,
    }
