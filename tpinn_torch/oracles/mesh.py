"""The gmsh 4.1 ASCII mesh reader (no meshio).

The coronary case's domain is the parametric stenosis mesh
``coroParam.msh`` (gmsh 4.1 ASCII, 10,833 nodes and 20,864 triangles; a
copy travels with the package in ``tpinn_torch/oracles/data``).  The
reader gives the node coordinates in node-tag order, the node tags and
the 3-node triangles as 0-based indices into the nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GmshMesh(NamedTuple):
    nodes: np.ndarray       # (M, 3) coordinates in node-tag order
    node_tags: np.ndarray   # (M,) gmsh node tags
    triangles: np.ndarray   # (T, 3) 0-based indices into nodes (may be empty)


def read_gmsh(path) -> GmshMesh:
    """The nodes and triangles of a gmsh 4.1 ASCII file; ValueError for
    another format or a file without nodes."""
    with open(path) as f:
        lines = f.read().splitlines()

    def section(name):
        try:
            start = lines.index(f"${name}") + 1
            end = lines.index(f"$End{name}")
        except ValueError:
            return None
        return lines[start:end]

    fmt = section("MeshFormat")
    if fmt is None or not fmt[0].startswith("4.1"):
        raise ValueError(f"unsupported gmsh format: {fmt and fmt[0]!r}")

    node_lines = section("Nodes")
    if node_lines is None:
        raise ValueError("no $Nodes section")
    num_blocks = int(node_lines[0].split()[0])
    idx = 1
    tags = []
    coords = []
    for _ in range(num_blocks):
        n_in_block = int(node_lines[idx].split()[3])
        idx += 1
        tags += [int(node_lines[idx + i]) for i in range(n_in_block)]
        idx += n_in_block
        coords += [[float(c) for c in node_lines[idx + i].split()[:3]]
                   for i in range(n_in_block)]
        idx += n_in_block

    tags = np.asarray(tags, dtype=np.int64)
    coords = np.asarray(coords, dtype=np.float64)
    tag_to_idx = {int(t): i for i, t in enumerate(tags)}

    tris = []
    elem_lines = section("Elements")
    if elem_lines is not None:
        num_blocks = int(elem_lines[0].split()[0])
        idx = 1
        for _ in range(num_blocks):
            _dim, _etag, etype, n_in_block = (
                int(x) for x in elem_lines[idx].split())
            idx += 1
            if etype == 2:  # 3-node triangle
                for i in range(n_in_block):
                    parts = elem_lines[idx + i].split()
                    tris.append([tag_to_idx[int(p)] for p in parts[1:4]])
            idx += n_in_block
    triangles = (np.asarray(tris, dtype=np.int64) if tris
                 else np.zeros((0, 3), dtype=np.int64))
    return GmshMesh(coords, tags, triangles)
