"""Flax variables as flat arrays: the file format of an exported run's
weights (numpy only, so the exporter runs where torch does not).

An .npz holds one array per leaf of the `params`, `batch_stats` and
`spectral` collections, keyed `<collection>/<path/with/slashes>`. flax names
its spectral state with one slashed key ('conv/kernel/u'); `flatten_tree`
splits such keys, so a leaf reads the same before and after the round trip.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

COLLECTIONS = ("params", "batch_stats", "spectral")


def flatten_tree(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """Yield (path, leaf) of a nested mapping, keys split on '/'."""
    for k, v in tree.items():
        key = prefix + tuple(str(k).split("/"))
        if isinstance(v, Mapping):
            yield from flatten_tree(v, key)
        else:
            yield key, v


def flatten_variables(
        variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Flax variables -> {'<collection>/<path/with/slashes>': float32}."""
    return {"/".join((col,) + path): np.asarray(leaf, np.float32)
            for col in COLLECTIONS if col in variables
            for path, leaf in flatten_tree(variables[col])}


def unflatten_variables(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The nested variables of `flatten_variables`' keys; raises on a key
    outside the three collections."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        col, *path = k.split("/")
        if col not in COLLECTIONS or not path:
            raise KeyError(f"unknown variable key {k!r}")
        node = out.setdefault(col, {})
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(v)
    return out


def read_flax_npz(path: str) -> Dict[str, Any]:
    """The nested variables stored in an .npz written from
    `flatten_variables`."""
    with np.load(path) as npz:
        return unflatten_variables({k: npz[k] for k in npz.files})
