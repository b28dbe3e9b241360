"""The checkpoint format: a directory of NumPy arrays plus a JSON tree.

One checkpoint is one directory holding

- ``arrays.npz`` — every leaf of the pytree as a NumPy array, keyed by its
  position in ``jax.tree_util`` flatten order (dtypes NumPy cannot name,
  such as bfloat16, are stored as raw unsigned bytes of the same width);
- ``tree.json`` — the format tag, each leaf's key path and dtype, and
  free-form metadata.  Written last, so a directory without it is an
  unfinished save.

Restore with a template (the same structure, e.g. a freshly initialised
training state) returns exactly the template's pytree types — optax's named
tuples included — and places each leaf with the template leaf's sharding
when it has one.  Restore without a template returns nested dicts (sequence
positions as list entries, named-tuple fields as dict keys).

:func:`save_tree` replaces an existing checkpoint kill-safely: the new
directory is written beside it as ``<path>.new`` and swapped in with two
renames (live -> ``<path>.old``, new -> live), so a kill at any instant
leaves the previous or the new checkpoint readable (:func:`live_path`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import jax
import numpy as np

FORMAT = "icee-npz-1"
_ARRAYS = "arrays.npz"
_TREE = "tree.json"


def _path_entry(k) -> list:
    if isinstance(k, jax.tree_util.SequenceKey):
        return ["seq", k.idx]
    if isinstance(k, jax.tree_util.DictKey):
        return ["dict", k.key]
    if isinstance(k, jax.tree_util.GetAttrKey):
        return ["attr", k.name]
    raise TypeError(f"unsupported pytree key {k!r}")


def _storable(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V":  # bfloat16 and the other ml_dtypes types
        return arr.view(np.dtype(f"u{arr.dtype.itemsize}"))
    return arr


def _write(path: str, tree: Any, metadata: Optional[dict]) -> None:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = [np.asarray(leaf) for _, leaf in flat]
    os.makedirs(path)
    np.savez(os.path.join(path, _ARRAYS),
             **{str(i): _storable(a) for i, a in enumerate(arrays)})
    spec = {
        "format": FORMAT,
        "leaves": [{"path": [_path_entry(k) for k in p],
                    "dtype": a.dtype.name}
                   for (p, _), a in zip(flat, arrays)],
        "metadata": metadata or {},
    }
    with open(os.path.join(path, _TREE), "w") as f:
        json.dump(spec, f)


def save_tree(path: str, tree: Any, metadata: Optional[dict] = None) -> str:
    """Write ``tree`` as the checkpoint directory ``path`` (replacing any
    previous one kill-safely); returns ``path``."""
    path = os.path.abspath(path)
    new, old = path + ".new", path + ".old"
    if os.path.isdir(new):
        shutil.rmtree(new)
    _write(new, tree, metadata)
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(path):
        os.rename(path, old)
    os.rename(new, path)
    if os.path.isdir(old):
        shutil.rmtree(old)
    return path


def live_path(path: str) -> Optional[str]:
    """The readable checkpoint at ``path``: ``path`` itself, or the
    ``.old`` survivor of a save killed between its two renames."""
    path = os.path.abspath(path)
    for p in (path, path + ".old"):
        if os.path.isfile(os.path.join(p, _TREE)):
            return p
    return None


def _read(path: str):
    with open(os.path.join(path, _TREE)) as f:
        spec = json.load(f)
    if spec.get("format") != FORMAT:
        raise ValueError(f"{path}: not an {FORMAT} checkpoint")
    with np.load(os.path.join(path, _ARRAYS), allow_pickle=False) as z:
        arrays = [z[str(i)].view(jax.numpy.dtype(leaf["dtype"]))
                  for i, leaf in enumerate(spec["leaves"])]
    return spec, arrays


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in sorted(node)]
    return node


def load_tree(path: str, template: Any = None) -> Any:
    """Restore the checkpoint at ``path`` (see the module docstring)."""
    live = live_path(path)
    if live is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    spec, arrays = _read(live)
    if template is None:
        root: dict = {}
        for leaf, arr in zip(spec["leaves"], arrays):
            node = root
            keys = [k for _, k in leaf["path"]]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
        return _lists(root)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    want = [[_path_entry(k) for k in p] for p, _ in flat]
    got = [leaf["path"] for leaf in spec["leaves"]]
    if want != got:
        raise ValueError(f"{path}: checkpoint structure does not match the "
                         "template")
    leaves = [jax.device_put(arr, t.sharding) if isinstance(t, jax.Array)
              else arr for (_, t), arr in zip(flat, arrays)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def metadata(path: str) -> dict:
    """The metadata dict saved with the checkpoint at ``path``."""
    live = live_path(path)
    if live is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    with open(os.path.join(live, _TREE)) as f:
        return json.load(f)["metadata"]


def remove(path: str) -> None:
    """Delete the checkpoint at ``path`` and any swap remnants."""
    path = os.path.abspath(path)
    for p in (path, path + ".old", path + ".new"):
        if os.path.isdir(p):
            shutil.rmtree(p)
