"""Binary PLY point-cloud IO (parity: ply.py in the reference).

A copy of ``omnifusion_tpu/utils/ply.py``: write_ply / read_ply with binary
little-endian format, supporting per-point fields (xyz + optional
colors/normals), and ``depth_to_pointcloud`` for exporting predicted depth
as point clouds (test.py:239-240). The sphere rays are those of the JAX
package's ``ops/depth2normal.py: _sphere_xyz`` (``geometry/sphere.py``'s
coords2uv / uv2xyz, util.py:159-174), copied here.
"""

from __future__ import annotations

import numpy as np

_NP_TO_PLY = {
    "int8": "char",
    "uint8": "uchar",
    "int16": "short",
    "uint16": "ushort",
    "int32": "int",
    "uint32": "uint",
    "float32": "float",
    "float64": "double",
}
_PLY_TO_NP = {v: k for k, v in _NP_TO_PLY.items()}
_PLY_TO_NP.update({"float": "float32", "double": "float64"})


def write_ply(filename: str, points, field_names=("x", "y", "z")) -> bool:
    """Write points to a binary PLY file.

    points: a single (N, k) array or a list of arrays concatenated along
    columns; field_names must cover every column.
    """
    if not isinstance(points, (list, tuple)):
        points = [points]
    points = [np.asarray(p) if p.ndim == 2 else np.asarray(p)[:, None] for p in points]
    n_cols = sum(p.shape[1] for p in points)
    if n_cols != len(field_names):
        raise ValueError(f"{n_cols} columns but {len(field_names)} field names")
    n = points[0].shape[0]
    if not filename.endswith(".ply"):
        filename += ".ply"

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    dtype_fields = []
    i = 0
    for p in points:
        for c in range(p.shape[1]):
            ply_type = _NP_TO_PLY[p.dtype.name]
            header.append(f"property {ply_type} {field_names[i]}")
            dtype_fields.append((field_names[i], p.dtype.str))
            i += 1
    header.append("end_header")

    data = np.empty(n, dtype=dtype_fields)
    i = 0
    for p in points:
        for c in range(p.shape[1]):
            data[field_names[i]] = p[:, c]
            i += 1

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        data.tofile(f)
    return True


def read_ply(filename: str) -> np.ndarray:
    """Read a binary little-endian PLY file -> structured array."""
    with open(filename, "rb") as f:
        line = f.readline().decode("ascii").strip()
        if line != "ply":
            raise ValueError(f"{filename!r} is not a ply file")
        fmt = None
        n = 0
        props: list[tuple[str, str]] = []
        while True:
            line = f.readline().decode("ascii").strip()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element" and parts[1] == "vertex":
                n = int(parts[2])
            elif parts[0] == "property":
                props.append((parts[2], _PLY_TO_NP[parts[1]]))
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported ply format {fmt!r}")
        return np.fromfile(f, dtype=[(name, "<" + np.dtype(t).str[1:]) for name, t in props], count=n)


def sphere_xyz(h: int, w: int) -> np.ndarray:
    """(H, W, 3) f32 unit rays of the ERP pixel centres: x = cos(v) sin(u),
    y = cos(v) cos(u), z = sin(v), u the longitude and v the latitude of
    1-based pixel coordinates (util.py:159-174)."""
    coords = np.stack(np.meshgrid(range(w), range(h)), -1).reshape(-1, 2) + 1
    u = (coords[:, 0] - (w / 2 + 0.5)) / w * 2 * np.pi
    v = -(coords[:, 1] - (h / 2 + 0.5)) / h * np.pi
    xyz = np.stack([np.cos(v) * np.sin(u), np.cos(v) * np.cos(u), np.sin(v)], -1)
    return xyz.reshape(h, w, 3).astype(np.float32)


def depth_to_pointcloud(depth, rgb=None):
    """ERP depth (H, W, 1) -> xyz points (H*W, 3) [+ colors (H*W, 3) uint8]."""
    h, w = depth.shape[:2]
    xyz = sphere_xyz(h, w).reshape(-1, 3) * np.asarray(depth).reshape(-1, 1)
    if rgb is None:
        return xyz.astype(np.float32)
    colors = (np.asarray(rgb).reshape(-1, 3) * 255).clip(0, 255).astype(np.uint8)
    return xyz.astype(np.float32), colors
