"""LPIPS perceptual metric in PyTorch (port of gsplat_tpu/eval/lpips.py).

The reference's self-contained LPIPS v0.1 (lpipsPyTorch/): a frozen
feature network (VGG16 / AlexNet / SqueezeNet-1.1 conv stacks,
lpipsPyTorch/modules/networks.py:66-96), unit-normalised activations per
tapped layer, and 1x1 linear heads, averaged over space and summed over
layers (modules/lpips.py:31-36). Written as plain ``torch.nn.functional``
convolutions and pools, NCHW inside; images are [H, W, 3] in [0, 1]
outside, as in the JAX API.

The convolutions run with TF32 off, scoped to the call: cuDNN would take
float32 convolutions through TF32 by default on the card, which moves
LPIPS by about 1e-3 from a float32 result. The process-wide flag is left
as it was.

Weight sourcing: no weights are downloaded. They load from the
``LPIPS_WEIGHTS_NPZ`` environment variable or an ``lpips_{net}.npz`` next
to this module, with the JAX module's key names (``conv{i}_w`` /
``conv{i}_b`` OIHW backbone, ``lin{i}_w`` heads); exported once with the
helpers below on a machine with the ``lpips`` package. Without true-head
weights ``lpips()`` raises LPIPSUnavailable, and callers (metrics.py)
report an explicit "unavailable" marker plus null, never a silently wrong
number (there is deliberately no approximate fallback).

Export helper (run on a machine with weights):
    python -m gsplat_tpu_torch.eval.lpips export vgg /path/out.npz
"""

from __future__ import annotations

import contextlib
import functools
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


class LPIPSUnavailable(RuntimeError):
    pass


# VGG16 feature-extractor conv plan: (out_channels, layers) per block;
# LPIPS taps activations after each block's final ReLU (pre-pool), i.e.
# torchvision feature indices 4, 9, 16, 23, 30 (networks.py:95).
_VGG_PLAN = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]

# SqueezeNet 1.1 Fire plan: (squeeze_ch, expand_ch), output 2 * expand_ch.
_FIRE_PLAN = [(16, 64), (16, 64), (32, 128), (32, 128),
              (48, 192), (48, 192), (64, 256), (64, 256)]

# Tapped-channel widths per net (networks.py:72,84,96), also the number of
# linear heads the npz must carry.
NET_CHANNELS = {
    "vgg": [64, 128, 256, 512, 512],
    "alex": [64, 192, 384, 256, 256],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}

# ImageNet normalisation of LPIPS's ScalingLayer (lpips v0.1 constants,
# networks.py:41-44).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 for the duration (TF32 is
    cuDNN's default for float32 convolutions on the card)."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


def _conv(params, i, x, stride=1, pad=1):
    return F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                    stride=stride, padding=pad)


def _zscore(x):
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    return (x - shift[None, :, None, None]) / scale[None, :, None, None]


def vgg16_features(params: Dict[str, torch.Tensor], x) -> List[torch.Tensor]:
    """x: [N, 3, H, W] in [-1, 1] (LPIPS input convention). Returns the 5
    tapped activations."""
    x = _zscore(x)
    feats = []
    idx = 0
    for block, (_, n_layers) in enumerate(_VGG_PLAN):
        for _ in range(n_layers):
            x = F.relu(_conv(params, idx, x))
            idx += 1
        feats.append(x)
        if block < len(_VGG_PLAN) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def alexnet_features(params: Dict[str, torch.Tensor],
                     x) -> List[torch.Tensor]:
    """torchvision alexnet.features with taps after each ReLU
    (networks.py:77-85, target_layers [2,5,8,10,12] 1-based)."""
    x = _zscore(x)
    feats = []
    # (kernel, stride, pad) per conv; pools sit after convs 0 and 1.
    specs = [(11, 4, 2), (5, 1, 2), (3, 1, 1), (3, 1, 1), (3, 1, 1)]
    for i, (_, s, p) in enumerate(specs):
        x = F.relu(_conv(params, i, x, stride=s, pad=p))
        feats.append(x)
        if i < 2:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _fire(params, idx, x):
    """SqueezeNet Fire: 1x1 squeeze + ReLU, then concat(1x1 expand, 3x3
    expand), each + ReLU; three convs numbered from ``idx`` in torch
    parameter order (squeeze, expand1x1, expand3x3)."""
    s = F.relu(_conv(params, idx, x, pad=0))
    e1 = F.relu(_conv(params, idx + 1, s, pad=0))
    e3 = F.relu(_conv(params, idx + 2, s, pad=1))
    return torch.cat([e1, e3], dim=1), idx + 3


def squeezenet_features(params: Dict[str, torch.Tensor],
                        x) -> List[torch.Tensor]:
    """torchvision squeezenet1_1.features with taps at indices
    [2,5,8,10,11,12,13] 1-based (networks.py:66-73): the stem ReLU and the
    2nd, 4th, 5th, 6th, 7th and 8th Fire modules; ceil-mode max pools."""
    x = _zscore(x)
    x = F.relu(_conv(params, 0, x, stride=2, pad=0))
    feats = [x]                                       # module 1 (stem ReLU)
    idx = 1
    pool = functools.partial(F.max_pool2d, kernel_size=3, stride=2,
                             ceil_mode=True)
    x = pool(x)                                       # module 2
    x, idx = _fire(params, idx, x)                    # module 3
    x, idx = _fire(params, idx, x)                    # module 4
    feats.append(x)
    x = pool(x)                                       # module 5
    x, idx = _fire(params, idx, x)                    # module 6
    x, idx = _fire(params, idx, x)                    # module 7
    feats.append(x)
    x = pool(x)                                       # module 8
    for _ in range(4):                                # modules 9-12
        x, idx = _fire(params, idx, x)
        feats.append(x)
    return feats


_FEATURE_FNS = {
    "vgg": vgg16_features,
    "alex": alexnet_features,
    "squeeze": squeezenet_features,
}


def _normalize_tensor(x, eps=1e-10):
    """Unit norm over channels (dim 1 of NCHW)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


@functools.lru_cache(maxsize=3)
def _load_weights(net: str = "vgg") -> Dict[str, np.ndarray]:
    """The npz's arrays (host numpy); raises LPIPSUnavailable without
    true linear heads."""
    if net not in NET_CHANNELS:
        raise ValueError(f"unknown LPIPS net {net!r}; choose from "
                         f"{sorted(NET_CHANNELS)}")
    path = os.environ.get("LPIPS_WEIGHTS_NPZ", "")
    candidates = [path] if path else []
    candidates.append(os.path.join(os.path.dirname(__file__),
                                   f"lpips_{net}.npz"))
    for c in candidates:
        if c and os.path.exists(c):
            z = np.load(c)
            params = {k: z[k] for k in z.files}
            missing = [i for i in range(len(NET_CHANNELS[net]))
                       if f"lin{i}_w" not in params]
            if missing:
                raise LPIPSUnavailable(
                    f"{c} lacks true LPIPS linear heads (lin*_w); refusing "
                    "to compute a not-quite-LPIPS number")
            return params
    raise LPIPSUnavailable(
        "LPIPS weights not found: set LPIPS_WEIGHTS_NPZ or place "
        f"lpips_{net}.npz next to gsplat_tpu_torch/eval/lpips.py (export "
        f"with `python -m gsplat_tpu_torch.eval.lpips export {net} "
        "out.npz` on a machine with the lpips package)")


def conv_shapes(net: str) -> List[tuple]:
    """OIHW shape of each conv{i}_w of ``net``'s feature stack, in order."""
    if net == "vgg":
        shapes, cin = [], 3
        for ch, n_layers in _VGG_PLAN:
            for _ in range(n_layers):
                shapes.append((ch, cin, 3, 3))
                cin = ch
        return shapes
    if net == "alex":
        return [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                (256, 384, 3, 3), (256, 256, 3, 3)]
    if net == "squeeze":
        shapes, cin = [(64, 3, 3, 3)], 64
        for sq, ex in _FIRE_PLAN:
            shapes += [(sq, cin, 1, 1), (ex, sq, 1, 1), (ex, sq, 3, 3)]
            cin = 2 * ex
        return shapes
    raise ValueError(f"unknown LPIPS net {net!r}")


def random_params(net: str, seed: int) -> Dict[str, np.ndarray]:
    """Random weights in the npz layout (He-scaled convs, small biases,
    positive heads), drawn from numpy at ``seed``: NOT LPIPS weights. The
    tests and the card smoke test run the metric's arithmetic on them."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, shape in enumerate(conv_shapes(net)):
        fan_in = shape[1] * shape[2] * shape[3]
        params[f"conv{i}_w"] = (rng.normal(size=shape)
                                * np.sqrt(2.0 / fan_in)).astype(np.float32)
        params[f"conv{i}_b"] = (0.01 * rng.normal(size=shape[0])
                                ).astype(np.float32)
    for i, ch in enumerate(NET_CHANNELS[net]):
        params[f"lin{i}_w"] = (np.abs(rng.normal(size=ch)) / ch
                               ).astype(np.float32)
    return params


def _on(params, device) -> Dict[str, torch.Tensor]:
    return {k: (v.to(device=device, dtype=torch.float32)
                if torch.is_tensor(v) else
                torch.as_tensor(np.asarray(v, np.float32), device=device))
            for k, v in params.items()}


@functools.lru_cache(maxsize=6)
def _device_weights(net: str, device: torch.device):
    """The loaded weights as float32 tensors on ``device``, kept so that a
    run over many views copies them once."""
    return _on(_load_weights(net), device)


@torch.no_grad()
def lpips_from_params(params, img1, img2, net: str = "vgg"):
    """Core distance given explicit weights (numpy arrays or tensors keyed
    as in the npz); ``img1`` / ``img2`` [H, W, 3] in [0, 1] on one device.
    Returns a 0-d float32 tensor on that device."""
    device = img1.device
    p = _on(params, device)
    x1 = img1.permute(2, 0, 1)[None] * 2.0 - 1.0
    x2 = img2.permute(2, 0, 1)[None] * 2.0 - 1.0
    feature_fn = _FEATURE_FNS[net]
    with _no_tf32():
        f1 = feature_fn(p, x1)
        f2 = feature_fn(p, x2)
    total = torch.zeros((), dtype=torch.float32, device=device)
    for i, (a, b) in enumerate(zip(f1, f2)):
        d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
        w = p[f"lin{i}_w"]  # [C] true LPIPS head (guaranteed by the loader)
        total = total + torch.mean(torch.sum(d * w[None, :, None, None],
                                             dim=1))
    return total


def lpips(img1, img2, net: str = "vgg"):
    """img1/img2: [H, W, 3] in [0, 1]. Returns the scalar LPIPS distance."""
    return lpips_from_params(_device_weights(net, img1.device), img1, img2,
                             net)


def export_from_lpips_package(net: str, out_path: str) -> None:
    """Run on a machine WITH the ``lpips`` pip package + weights to export
    an npz usable here (backbone convs + true linear heads)."""
    import lpips as lpips_pkg  # type: ignore

    model = lpips_pkg.LPIPS(net=net)
    seen = export_torch_features(model.net.named_parameters())
    for i, lin in enumerate(model.lins):
        w = lin.model[1].weight.detach().numpy()  # [1, C, 1, 1]
        seen[f"lin{i}_w"] = w[0, :, 0, 0]
    np.savez(out_path, **seen)


def export_torch_features(named_parameters) -> Dict[str, np.ndarray]:
    """Torch conv params (in definition order) -> the conv{i}_w/_b naming
    this module uses. Works for vgg16/alexnet/squeezenet1_1 feature stacks
    (Fire submodules enumerate squeeze, expand1x1, expand3x3 — definition
    order matches parameter order)."""
    seen = {}
    ci = 0
    for n, p in named_parameters:
        if n.endswith(".weight") and p.dim() == 4:
            seen[f"conv{ci}_w"] = p.detach().cpu().numpy()
        elif n.endswith(".bias"):
            seen[f"conv{ci}_b"] = p.detach().cpu().numpy()
            ci += 1
    return seen


if __name__ == "__main__":
    import sys

    if len(sys.argv) == 4 and sys.argv[1] == "export":
        export_from_lpips_package(sys.argv[2], sys.argv[3])
