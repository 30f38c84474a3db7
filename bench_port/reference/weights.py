"""The committed checkpoint's raw arrays, read with numpy alone.

The file is a JAX-layout ``.npz``: every leaf is stored under
``tree:`` + its key path, e.g. ``tree:['params'].coarse['pts_linears'][0]['weight']``,
with ``[in, out]`` weights in float16. ``read_params`` returns the
``params`` subtree as nested dicts and lists of float32 arrays, the same
structure for the program's loader and for the reference: both are handed
these arrays and nothing else.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_TOKEN = re.compile(r"\['([^']*)'\]|\.(\w+)|\[(\d+)\]")


def _path(key: str) -> list:
    out, pos = [], 0
    while pos < len(key):
        m = _TOKEN.match(key, pos)
        if m is None:
            raise ValueError(f"unreadable key path {key!r}")
        name, attr, index = m.groups()
        out.append(int(index) if index is not None else (name if name is not None else attr))
        pos = m.end()
    return out


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def read_params(path: str, sha256: str | None = None) -> dict:
    """{"coarse": ..., "fine": ..., "depth": ...}: each dense layer a dict
    {"weight": [in, out] float32, "bias": [out] float32}. With ``sha256``,
    a file whose bytes hash to another digest is refused (``ValueError``)."""
    if sha256 is not None:
        with open(path, "rb") as fp:
            got = hashlib.sha256(fp.read()).hexdigest()
        if got != sha256:
            raise ValueError(f"{path} has sha256 {got}, not the {sha256} its configuration names")
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith("tree:['params']"):
                continue
            parts = _path(key[len("tree:"):])[1:]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key], np.float32)
    return _lists(tree)

