"""Gaussian parameter state with a fixed capacity and an alive prefix
(port of gsplat_tpu/model/gaussians.py).

Rows [0, n_alive) are alive; the rest are zero padding up to ``capacity``
(= cap_max), as in the JAX package, so the rasterizer sees the same P.
Activations match the reference (gaussian_model_static.py:32-50):
scaling = exp(raw), opacity = sigmoid(raw), rotation = normalize(raw).
``create_from_points`` needs the 3-NN initialisation and belongs to the
training slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.quaternion import normalize

PARAM_KEYS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


@dataclasses.dataclass(frozen=True)
class GaussianState:
    """Raw (pre-activation) parameters, padded to ``capacity`` rows, all on
    one device. features_dc [C, 1, 3], features_rest [C, K-1, 3] with
    K = (max_sh_degree + 1)^2 — the reference layout."""

    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] log-scale
    rotation: torch.Tensor       # [C, 4] (w,x,y,z) unnormalized
    opacity: torch.Tensor        # [C, 1] logit
    n_alive: int
    max_sh_degree: int

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def alive_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device) < self.n_alive

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_rotation(self):
        return normalize(self.rotation)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_features(self):
        """[C, K, 3] concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_covariance(self, scaling_modifier: float = 1.0):
        """Packed 6-vector 3D covariance (the cov3d_precomp input)."""
        from gsplat_tpu_torch.core.covariance import covariance_6

        return covariance_6(self.get_scaling(), self.get_rotation(),
                            scaling_modifier)

    def params(self) -> dict[str, torch.Tensor]:
        """The trainable leaves, keyed like the reference optimizer groups."""
        return {"xyz": self.xyz, "f_dc": self.features_dc,
                "f_rest": self.features_rest, "opacity": self.opacity,
                "scaling": self.scaling, "rotation": self.rotation}


def state_from_numpy(params: dict[str, np.ndarray], n_alive: int,
                     max_sh_degree: int,
                     device: str | torch.device = "cuda") -> GaussianState:
    """GaussianState from numpy leaves keyed as ``GaussianState.params()``
    (the JAX state's leaves as numpy arrays), copied to ``device``."""
    device = get_device(device)
    t = {k: torch.as_tensor(np.ascontiguousarray(params[k], np.float32),
                            device=device) for k in PARAM_KEYS}
    capacity = t["xyz"].shape[0]
    if not 0 <= n_alive <= capacity:
        raise ValueError(f"n_alive {n_alive} outside [0, {capacity}]")
    k = (max_sh_degree + 1) ** 2
    if t["f_rest"].shape[1:] != (k - 1, 3):
        raise ValueError(f"f_rest {tuple(t['f_rest'].shape)} does not match "
                         f"SH degree {max_sh_degree}")
    return GaussianState(xyz=t["xyz"], features_dc=t["f_dc"],
                         features_rest=t["f_rest"], scaling=t["scaling"],
                         rotation=t["rotation"], opacity=t["opacity"],
                         n_alive=int(n_alive), max_sh_degree=max_sh_degree)


def _pad(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} Gaussians exceed capacity {capacity}")
    pad = np.zeros((capacity - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def load_ply(path: str, capacity: int, max_sh_degree: int,
             device: str | torch.device = "cuda") -> GaussianState:
    """Load a reference-format Gaussian PLY into a padded state
    (gaussian_model_static.py:251-296)."""
    from gsplat_tpu_torch.data import ply

    leaves = ply.load_gaussian_ply(path, max_sh_degree)
    n = leaves[0].shape[0]
    params = {k: _pad(v, capacity) for k, v in zip(
        ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"), leaves)}
    return state_from_numpy(params, n, max_sh_degree, device)


def save_ply(state: GaussianState, path: str) -> None:
    """Write the alive rows in the reference PLY layout
    (gaussian_model_static.py:228-249)."""
    from gsplat_tpu_torch.data import ply

    n = state.n_alive
    p = {k: v[:n].detach().cpu().numpy() for k, v in state.params().items()}
    ply.save_gaussian_ply(path, p["xyz"], p["f_dc"], p["f_rest"],
                          p["opacity"], p["scaling"], p["rotation"])
