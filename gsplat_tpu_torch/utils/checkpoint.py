"""Training-context checkpoints (port of gsplat_tpu/utils/checkpoint.py).

The analogue of torch.save((gaussians.capture(), iteration)) ->
chkpnt{iter}.pth (reference train_static.py:142-144,
gaussian_model_static.py:84-124): the Gaussian parameters, the Adam
moments and step count, the alive count and a few scalars, in one .npz
with no pickled code.

The layout is the JAX package's, so a checkpoint written by either
package loads in the other:

- ``save`` / ``load``: ``state/<leaf>``, ``state/n_alive``,
  ``adam/{mu,nu}/<group>``, ``adam/count`` and a ``__meta__`` JSON with
  ``iteration``, ``max_sh_degree`` and ``extra``;
- ``save_pytree`` / ``load_pytree``: every leaf under the key that
  ``jax.tree_util.keystr`` gives its path in the JAX pytree (``['state'].
  im.xyz``, ``['adam'].mu['f_dc']``, ...). Dicts flatten in sorted key
  order, the dataclasses in their field order without their static fields
  (``max_sh_degree``, ``max_lifespan``, ``deform``), ``AdamState`` as a
  named tuple.

Host ints (``n_alive``, ``m_count``, Adam's ``count``) are stored as int32
scalars, as the JAX package's device scalars are.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from gsplat_tpu_torch.model import optim
from gsplat_tpu_torch.model.gaussians import GaussianState

STATE_LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity")
# dataclass fields that JAX registers as static metadata, not leaves
_STATIC_FIELDS = frozenset({"max_sh_degree", "max_lifespan", "deform"})


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf)
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _children(node) -> list[Tuple[str, Any]]:
    """(key suffix in keystr form, child) of a pytree node, [] for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)
                if f.name not in _STATIC_FIELDS]
    return []


def flatten_with_keys(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) pairs in JAX's flatten order."""
    children = _children(tree)
    if not children:
        yield prefix, tree
        return
    for suffix, child in children:
        yield from flatten_with_keys(child, prefix + suffix)


def _rebuild(template, z, prefix: str):
    children = _children(template)
    if not children:
        arr = z[prefix]
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(arr, device=template.device)
        return type(template)(arr)
    built = {s: _rebuild(c, z, prefix + s) for s, c in children}
    if isinstance(template, dict):
        return {k: built[f"[{k!r}]"] for k in template}
    if isinstance(template, tuple):
        return type(template)(**{f: built[f".{f}"]
                                 for f in template._fields})
    return dataclasses.replace(template, **{s[1:]: v
                                            for s, v in built.items()})


def save_pytree(path: str, tree, meta: Dict[str, Any] | None = None) -> None:
    """Write every leaf of ``tree`` under its JAX keystr."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {k: _host(v) for k, v in flatten_with_keys(tree)}
    np.savez(path, __meta__=json.dumps(meta or {}), **arrays)


def load_pytree(path: str, template):
    """(a tree like ``template`` with the file's leaves, meta). Tensors
    land on the device of the template's leaf; ints stay host ints."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        return _rebuild(template, z, ""), meta


def save(path: str, state: GaussianState, adam: optim.AdamState,
         iteration: int, extra: Dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"state/{n}": _host(getattr(state, n)) for n in STATE_LEAVES}
    arrays["state/n_alive"] = _host(state.n_alive)
    for group, leaf in adam.mu.items():
        arrays[f"adam/mu/{group}"] = _host(leaf)
    for group, leaf in adam.nu.items():
        arrays[f"adam/nu/{group}"] = _host(leaf)
    arrays["adam/count"] = _host(adam.count)
    meta = {"iteration": iteration, "max_sh_degree": state.max_sh_degree,
            "extra": extra or {}}
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path: str, device: str | torch.device = "cuda"):
    """(GaussianState, AdamState, iteration, extra) on ``device``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))

        def t(key):
            return torch.as_tensor(z[key], device=device)

        state = GaussianState(
            **{n: t(f"state/{n}") for n in STATE_LEAVES},
            n_alive=int(z["state/n_alive"]),
            max_sh_degree=int(meta["max_sh_degree"]))
        groups = sorted({k.split("/")[-1] for k in z.files
                         if k.startswith("adam/mu/")})
        adam = optim.AdamState(mu={g: t(f"adam/mu/{g}") for g in groups},
                               nu={g: t(f"adam/nu/{g}") for g in groups},
                               count=int(z["adam/count"]))
    return state, adam, int(meta["iteration"]), meta["extra"]
