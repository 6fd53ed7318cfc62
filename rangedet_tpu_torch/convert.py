"""Weight bridge between the JAX package's parameter tree and the port's
``state_dict``.

The JAX tree is the bhcw/planar one (``rangedet_tpu`` recipes train it):
nested dicts of numpy arrays, ``params`` and ``batch_stats``. Its module
paths are the port's module paths; leaves change name and layout:

  ``kernel`` (3, 3, Ci, Co) HWIO          -> ``weight`` (Co, Ci, 3, 3)
  ``conv2_kernel`` (3, 3, Ci, Co)          -> ``conv2_weight`` (Co, Ci, 3, 3)
  ``sc_kernel``, head ``*_kernel`` (Ci, Co) -> ``*_weight`` (Co, Ci, 1, 1)
  ``meta_agg/conv/kernel`` (1, 1, 9C, Co)  -> ``meta_agg.weight`` (Co, 9C, 1, 1)
  ``*_deconv/kernel`` (kh, kw, Ci, Co)     -> ``weight`` (Ci, Co, kh, kw),
      flipped in kh and kw: JAX applies it as a SAME transposed conv that
      correlates with the kernel as stored, ``F.conv_transpose2d`` with the
      flipped one
  Dense ``mlp*/kernel`` (in, out)          -> ``nn.Linear`` ``weight`` (out, in)
  BN ``scale``, ``mean``, ``var``          -> ``weight``, ``running_mean``,
                                              ``running_var``

A flat ``.npz`` of the tree (keys ``params/...`` and ``batch_stats/...``,
``/``-joined) is the file format of ``load_npz`` and ``save_npz``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _set(tree: Tree, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _param_to_torch(path: Tuple[str, ...], v: np.ndarray):
    parent, leaf = path[:-1], path[-1]
    if leaf == "kernel":
        if parent[-1] == "conv":  # meta_agg/conv/kernel
            parent = parent[:-1]
        if v.ndim == 4 and parent[-1].endswith("_deconv"):
            v = v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        elif v.ndim == 2:  # Dense
            v = v.T
        leaf = "weight"
    elif leaf.endswith("_kernel"):
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v.T[:, :, None, None]
        leaf = leaf[: -len("_kernel")] + "_weight"
    elif leaf == "scale":
        leaf = "weight"
    return parent + (leaf,), v


def _param_to_flax(path: Tuple[str, ...], t: np.ndarray, is_bn: bool):
    parent, leaf = path[:-1], path[-1]
    if leaf == "weight" and is_bn:
        leaf = "scale"
    elif leaf == "weight":
        if t.ndim == 4 and parent[-1].endswith("_deconv"):
            t = t[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        elif t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
            if parent[-1] == "meta_agg":
                parent = parent + ("conv",)
        elif t.ndim == 2:  # nn.Linear
            t = t.T
        leaf = "kernel"
    elif leaf.endswith("_weight"):
        t = t[:, :, 0, 0].T if t.shape[2:] == (1, 1) else t.transpose(2, 3, 1, 0)
        leaf = leaf[: -len("_weight")] + "_kernel"
    return parent + (leaf,), t


def flax_ndim(name: str, shape) -> int:
    """The rank of the JAX leaf that the port's parameter ``name`` of
    ``shape`` maps to, by ``_param_to_flax``'s rules: a 1x1 ``*_weight``
    (``sc_weight``, the head's projections) is (Ci, Co) there; every other
    leaf keeps its rank."""
    if name.rsplit(".", 1)[-1].endswith("_weight") and \
            tuple(shape[2:]) == (1, 1):
        return 2
    return len(shape)


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``params`` and ``batch_stats`` trees -> the port's state_dict."""
    sd = {}
    for path, v in _flatten(params):
        path, v = _param_to_torch(path, v)
        sd[".".join(path)] = torch.from_numpy(
            np.ascontiguousarray(v, np.float32))
    for path, v in _flatten(batch_stats):
        path = path[:-1] + (_STATS[path[-1]],)
        sd[".".join(path)] = torch.from_numpy(
            np.ascontiguousarray(v, np.float32))
    return sd


def to_flax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """Inverse of from_flax: (params, batch_stats) of numpy arrays."""
    inv_stats = {v: k for k, v in _STATS.items()}
    params: Tree = {}
    batch_stats: Tree = {}
    for key, t in state_dict.items():
        path = tuple(key.split("."))
        arr = t.detach().cpu().float().numpy()
        if path[-1] in inv_stats:
            _set(batch_stats, path[:-1] + (inv_stats[path[-1]],), arr)
            continue
        is_bn = ".".join(path[:-1] + ("running_mean",)) in state_dict
        path, arr = _param_to_flax(path, arr, is_bn)
        _set(params, path, np.ascontiguousarray(arr))
    return params, batch_stats


def save_npz(path: str, params: Mapping, batch_stats: Mapping) -> None:
    """Write the JAX tree as a flat .npz with '/'-joined keys."""
    flat = {"/".join(("params",) + p): v for p, v in _flatten(params)}
    flat.update({"/".join(("batch_stats",) + p): v
                 for p, v in _flatten(batch_stats)})
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a save_npz file into the port's state_dict."""
    trees: Dict[str, Tree] = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            top, *rest = key.split("/")
            if top not in trees:
                raise KeyError(f"{path}: key {key!r} is not under params/ "
                               "or batch_stats/")
            _set(trees[top], tuple(rest), z[key])
    return from_flax(trees["params"], trees["batch_stats"])
