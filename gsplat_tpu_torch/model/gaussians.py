"""Gaussian parameter state with a fixed capacity and an alive prefix
(port of gsplat_tpu/model/gaussians.py).

Rows [0, n_alive) are alive; the rest are zero padding up to ``capacity``
(= cap_max), as in the JAX package, so the rasterizer sees the same P.
Activations match the reference (gaussian_model_static.py:32-50):
scaling = exp(raw), opacity = sigmoid(raw), rotation = normalize(raw).
``n_alive`` is a host int: densification decides it on the host.
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

    def replace_params(self, p: dict[str, torch.Tensor]) -> "GaussianState":
        return dataclasses.replace(
            self, xyz=p["xyz"], features_dc=p["f_dc"],
            features_rest=p["f_rest"], opacity=p["opacity"],
            scaling=p["scaling"], rotation=p["rotation"])


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def _leaves_to(params: dict[str, np.ndarray], device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(params[k], np.float32),
                               device=device) for k in PARAM_KEYS}


def state_from_numpy(params: dict[str, np.ndarray], n_alive: int,
                     max_sh_degree: int,
                     device: str | torch.device = "cuda",
                     adam: tuple | None = None):
    """GaussianState from numpy leaves keyed as ``GaussianState.params()``
    (the JAX state's leaves as numpy arrays), copied to ``device``. With
    ``adam`` = (mu, nu, count) — JAX's AdamState moments as numpy dicts
    keyed the same way and its step count — returns (state,
    ``optim.AdamState``)."""
    device = get_device(device)
    t = _leaves_to(params, device)
    capacity = t["xyz"].shape[0]
    if not 0 <= n_alive <= capacity:
        raise ValueError(f"n_alive {n_alive} outside [0, {capacity}]")
    k = (max_sh_degree + 1) ** 2
    if t["f_rest"].shape[1:] != (k - 1, 3):
        raise ValueError(f"f_rest {tuple(t['f_rest'].shape)} does not match "
                         f"SH degree {max_sh_degree}")
    state = GaussianState(xyz=t["xyz"], features_dc=t["f_dc"],
                          features_rest=t["f_rest"], scaling=t["scaling"],
                          rotation=t["rotation"], opacity=t["opacity"],
                          n_alive=int(n_alive), max_sh_degree=max_sh_degree)
    if adam is None:
        return state
    from gsplat_tpu_torch.model import optim

    mu, nu, count = adam
    return state, optim.AdamState(mu=_leaves_to(mu, device),
                                  nu=_leaves_to(nu, device),
                                  count=int(count))


def _pad(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} Gaussians exceed capacity {capacity}")
    pad = np.zeros((capacity - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def create_from_points(points: np.ndarray, colors: np.ndarray,
                       capacity: int, max_sh_degree: int,
                       mean_sq_dist: np.ndarray | None = None,
                       device: str | torch.device = "cuda") -> GaussianState:
    """Initialise from a point cloud (reference create_from_pcd,
    gaussian_model_static.py:155-181): DC SH from RGB, higher bands zero;
    isotropic log-scale log(sqrt(clamp(meanSqDist3NN, 1e-7)) * 0.1);
    identity quaternion; opacity logit of 0.5."""
    from gsplat_tpu_torch.core.sh import rgb_to_sh
    from gsplat_tpu_torch.model.knn import mean_sq_dist_3nn

    device = get_device(device)
    n = points.shape[0]
    k = (max_sh_degree + 1) ** 2
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    f_dc = rgb_to_sh(colors).astype(np.float32).reshape(n, 1, 3)
    if mean_sq_dist is None:
        mean_sq_dist = mean_sq_dist_3nn(
            torch.as_tensor(points, device=device)).cpu().numpy()
    dist2 = np.maximum(mean_sq_dist, 1e-7)
    scales = np.log(np.sqrt(dist2) * 0.1)[:, None].repeat(3, axis=1)
    rots = np.zeros((n, 4), np.float32)
    rots[:, 0] = 1.0
    logit = float(inverse_sigmoid(torch.tensor(0.5)))
    params = {"xyz": points, "f_dc": f_dc,
              "f_rest": np.zeros((n, k - 1, 3), np.float32),
              "opacity": np.full((n, 1), logit, np.float32),
              "scaling": scales.astype(np.float32), "rotation": rots}
    return state_from_numpy({key: _pad(v, capacity)
                             for key, v in params.items()},
                            n, max_sh_degree, device)


def active_params(state: GaussianState, sh_degree: int):
    """Activated parameter views for the rasterizer."""
    del sh_degree  # the rasterizer takes the degree itself
    return dict(means3d=state.xyz, scales=state.get_scaling(),
                quats=state.get_rotation(),
                opacities=state.get_opacity()[:, 0],
                shs=state.get_features(), alive=state.alive_mask)


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
