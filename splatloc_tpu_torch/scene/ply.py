"""PLY import/export, byte-compatible with the reference map format.

Port of ``splatloc_tpu.scene.ply``: binary little endian PLY with float
vertex attributes
x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*,marker,kp_score. The
native IO library (``data/native_io.py``) reads and writes float PLYs where
it loads; the pure-numpy codec does the rest and writes the same bytes.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from splatloc_tpu_torch.scene.gaussians import GaussianScene

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply_vertices(path: str) -> dict:
    """Parse the vertex element of a PLY file -> {prop_name: np.array}."""
    from splatloc_tpu_torch.data import native_io
    nat = native_io.ply_read_f32(path) if native_io.available() else None
    if nat is not None:
        names, data = nat
        return {n: data[:, i] for i, n in enumerate(names)}
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = None
    elements = []  # (name, count, [(prop, dtype)])
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                raise ValueError("list properties not supported")
            cur[2].append((tok[2], _PLY_DTYPES[tok[1]]))

    offset = 0
    out = {}
    for name, count, props in elements:
        dt = np.dtype([(p, d) for p, d in props])
        if fmt == "binary_little_endian":
            arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
            offset += dt.itemsize * count
        elif fmt == "ascii":
            text = body.decode("ascii").splitlines()
            rows = [text[i].split() for i in range(count)]
            arr = np.array([tuple(map(float, r)) for r in rows], dtype=dt)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
        if name == "vertex":
            out = {p: np.asarray(arr[p]) for p, _ in props}
    return out


def write_ply(path: str, names: list[str], columns: np.ndarray):
    """Write binary_little_endian PLY with float32 vertex properties.
    columns: [N, len(names)]."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    from splatloc_tpu_torch.data import native_io
    if native_io.available() and native_io.ply_write_f32(
            path, names, np.asarray(columns, np.float32)):
        return
    n = columns.shape[0]
    buf = io.BytesIO()
    buf.write(b"ply\nformat binary_little_endian 1.0\n")
    buf.write(f"element vertex {n}\n".encode())
    for name in names:
        buf.write(f"property float {name}\n".encode())
    buf.write(b"end_header\n")
    buf.write(np.ascontiguousarray(columns.astype("<f4")).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def attribute_names(sh_degree: int) -> list[str]:
    """The reference's construct_list_of_attributes."""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    rest = 3 * ((sh_degree + 1) ** 2 - 1)
    names += [f"f_rest_{i}" for i in range(rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    names += ["marker", "kp_score"]
    return names


def save_scene(scene: GaussianScene, path: str):
    """Export alive Gaussians to the reference PLY schema."""
    def host(x):
        return x.detach().cpu().numpy()

    alive = host(scene.alive)
    xyz = host(scene.xyz)[alive]
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    # torch layout: _features_dc [N,1,3] -> transpose(1,2).flatten
    f_dc = host(scene.f_dc)[alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = host(scene.f_rest)[alive].transpose(0, 2, 1).reshape(n, -1)
    cols = np.concatenate([xyz, normals, f_dc, f_rest,
                           host(scene.opacity)[alive],
                           host(scene.scaling)[alive],
                           host(scene.rotation)[alive],
                           host(scene.marker)[alive],
                           host(scene.kp_score)[alive]], axis=1)
    write_ply(path, attribute_names(scene.sh_degree), cols)


def load_scene(path: str, sh_degree: int = 0, capacity: int | None = None,
               device="cuda") -> GaussianScene:
    """Import a reference-format PLY into a padded GaussianScene on
    ``device``."""
    v = read_ply_vertices(path)
    n = v["x"].shape[0]
    if capacity is None:
        capacity = n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} Gaussians in {path}")

    xyz = np.stack([v["x"], v["y"], v["z"]], -1)
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], -1)[:, None, :]
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    expected = 3 * ((sh_degree + 1) ** 2 - 1)
    if len(rest_names) != expected:
        raise ValueError(f"{path} has {len(rest_names)} f_rest attributes; "
                         f"SH degree {sh_degree} needs {expected}")
    if rest_names:
        # file layout is [3, R] flattened
        f_rest = np.stack([v[k] for k in rest_names], -1).reshape(
            n, 3, -1).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)

    def stacked(prefix):
        names = sorted((k for k in v if k.startswith(prefix)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([v[k] for k in names], -1)

    fields = {"xyz": xyz, "f_dc": f_dc, "f_rest": f_rest,
              "scaling": stacked("scale_"), "rotation": stacked("rot_"),
              "opacity": v["opacity"][:, None],
              "marker": v["marker"][:, None],
              "kp_score": v["kp_score"][:, None]}
    empty = GaussianScene.empty(capacity, sh_degree, device="cpu")
    full = {}
    for k, arr in fields.items():
        host = getattr(empty, k).numpy().copy()
        host[:n] = arr
        full[k] = torch.from_numpy(host).to(device)
    alive = torch.from_numpy(np.arange(capacity) < n).to(device)
    return GaussianScene(alive=alive, sh_degree=sh_degree, **full)
