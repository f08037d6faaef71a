"""COLMAP sparse-model I/O (cameras / images / points3D, text + binary).

Parity with the reference's COLMAP support (utils/colmap_utils.py:83-325 —
readers for both encodings plus quaternion converters; unused by its entry
points but part of its public surface). Re-implemented from the public
COLMAP format specification: https://colmap.github.io/format.html.
The port's own numpy copy of ``splatloc_tpu.data.colmap`` (the port
imports nothing of the JAX package).

Use cases here: importing COLMAP-reconstructed scenes as posed frames
(``model_to_poses``) and seeding a GaussianScene from the sparse points
(``points_array``).
"""
from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

# model_id -> (name, num_params) from the COLMAP camera-model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray          # [num_params] float64

    def K(self) -> np.ndarray:
        """3x3 intrinsics for the pinhole-family models."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fx, fy, cx, cy = p[0], p[0], p[1], p[2]
        elif self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE",
                            "FULL_OPENCV"):
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        else:
            raise ValueError(f"no pinhole K for model {self.model}")
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray            # [4] (w, x, y, z)
    tvec: np.ndarray            # [3]
    camera_id: int
    name: str
    xys: np.ndarray             # [M, 2]
    point3d_ids: np.ndarray     # [M] int64 (-1 = no track)

    def w2c(self) -> np.ndarray:
        """4x4 world-to-camera (COLMAP stores R=R(qvec), t s.t. x_c=Rx+t)."""
        T = np.eye(4)
        T[:3, :3] = qvec_to_rotmat(self.qvec)
        T[:3, 3] = self.tvec
        return T


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray             # [3]
    rgb: np.ndarray             # [3] uint8
    error: float
    image_ids: np.ndarray       # [K] int32
    point2d_idxs: np.ndarray    # [K] int32


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R) -> np.ndarray:
    """Branch-stable rotation-matrix -> (w,x,y,z), largest-pivot form."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
             (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
             (R[1, 2] + R[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q if q[0] >= 0 else -q


# ---------------------------------------------------------------- text


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    out = {}
    for line in _data_lines(path):
        el = line.split()
        cid, model = int(el[0]), el[1]
        out[cid] = ColmapCamera(cid, model, int(el[2]), int(el[3]),
                                np.asarray(el[4:], np.float64))
    return out


def read_images_text(path) -> dict[int, ColmapImage]:
    # Header/points rows are paired positionally; an image with zero 2D
    # points has an EMPTY points row (COLMAP emits one), so only comments
    # are filtered — blank lines must survive to keep the pairing aligned.
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.lstrip().startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    while lines and not lines[0]:
        lines.pop(0)
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.asarray(el[1:5], np.float64)
        tvec = np.asarray(el[5:8], np.float64)
        cam_id, name = int(el[8]), el[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        trip = np.asarray(pts, np.float64).reshape(-1, 3) if pts else \
            np.zeros((0, 3))
        out[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                               trip[:, :2].copy(),
                               trip[:, 2].astype(np.int64))
    return out


def read_points3d_text(path) -> dict[int, ColmapPoint3D]:
    out = {}
    for line in _data_lines(path):
        el = line.split()
        pid = int(el[0])
        track = np.asarray(el[8:], np.float64).reshape(-1, 2)
        out[pid] = ColmapPoint3D(
            pid, np.asarray(el[1:4], np.float64),
            np.asarray(el[4:7], np.float64).astype(np.uint8), float(el[7]),
            track[:, 0].astype(np.int32), track[:, 1].astype(np.int32))
    return out


def write_cameras_text(path, cameras: dict[int, ColmapCamera]):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cameras.values():
            p = " ".join(repr(float(v)) for v in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {p}\n")


def write_images_text(path, images: dict[int, ColmapImage]):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, "
                "NAME / POINTS2D as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            row = " ".join(f"{repr(float(x))} {repr(float(y))} {int(pid)}"
                           for (x, y), pid in zip(im.xys, im.point3d_ids))
            f.write(row + "\n")


def write_points3d_text(path, points: dict[int, ColmapPoint3D]):
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X Y Z, R G B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            tr = " ".join(f"{int(i)} {int(j)}"
                          for i, j in zip(p.image_ids, p.point2d_idxs))
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))} {tr}\n")


# ---------------------------------------------------------------- binary


def _read(fid, fmt):
    return struct.unpack("<" + fmt, fid.read(struct.calcsize("<" + fmt)))


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, "d" * np_), np.float64)
            out[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return out


def read_images_binary(path) -> dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "idddddddi")
            iid, cam_id = vals[0], vals[8]
            qvec = np.asarray(vals[1:5])
            tvec = np.asarray(vals[5:8])
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (m,) = _read(f, "Q")
            buf = np.frombuffer(f.read(24 * m), dtype=np.dtype(
                [("x", "<f8"), ("y", "<f8"), ("id", "<i8")]))
            out[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                np.stack([buf["x"], buf["y"]], -1) if m else
                np.zeros((0, 2)), buf["id"].astype(np.int64))
    return out


def read_points3d_binary(path) -> dict[int, ColmapPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            vals = _read(f, "QdddBBBd")
            pid = int(vals[0])
            (k,) = _read(f, "Q")
            buf = np.frombuffer(f.read(8 * k), dtype=np.dtype(
                [("im", "<i4"), ("p2", "<i4")]))
            out[pid] = ColmapPoint3D(
                pid, np.asarray(vals[1:4]),
                np.asarray(vals[4:7], np.uint8), float(vals[7]),
                buf["im"].astype(np.int32), buf["p2"].astype(np.int32))
    return out


def write_cameras_binary(path, cameras: dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path, images: dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3d_ids)))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))


def write_points3d_binary(path, points: dict[int, ColmapPoint3D]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<QdddBBBd", p.id, *p.xyz,
                                *(int(v) for v in p.rgb), p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for i, j in zip(p.image_ids, p.point2d_idxs):
                f.write(struct.pack("<ii", int(i), int(j)))


# ---------------------------------------------------------------- model


def read_model(path, ext: str | None = None):
    """(cameras, images, points3d) from a COLMAP sparse dir; ext None
    auto-detects .bin / .txt."""
    if ext is None:
        ext = ".bin" if os.path.exists(
            os.path.join(path, "cameras.bin")) else ".txt"
    if ext == ".bin":
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3d_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3d_text(os.path.join(path, "points3D.txt")))


def write_model(path, cameras, images, points3d, ext: str = ".bin"):
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(os.path.join(path, "cameras.bin"), cameras)
        write_images_binary(os.path.join(path, "images.bin"), images)
        write_points3d_binary(os.path.join(path, "points3D.bin"), points3d)
    else:
        write_cameras_text(os.path.join(path, "cameras.txt"), cameras)
        write_images_text(os.path.join(path, "images.txt"), images)
        write_points3d_text(os.path.join(path, "points3D.txt"), points3d)


def model_to_poses(cameras, images):
    """Sorted-by-name (names, c2w [N,4,4], K [3,3], (width, height)) for
    feeding the mapping pipeline from a COLMAP reconstruction.

    The mapping pipeline assumes one shared camera; a multi-camera model
    would silently get wrong K/size for the other rigs, so it is rejected.
    """
    items = sorted(images.values(), key=lambda im: im.name)
    cam_ids = {im.camera_id for im in items}
    if len(cam_ids) != 1:
        raise ValueError(
            f"model_to_poses needs a single shared camera, got camera_ids "
            f"{sorted(cam_ids)}; split the model per camera first")
    c2w = np.stack([np.linalg.inv(im.w2c()) for im in items])
    cam0 = cameras[items[0].camera_id]
    return [im.name for im in items], c2w, cam0.K(), (cam0.width,
                                                      cam0.height)


def points_array(points3d):
    """(xyz [N,3] float32, rgb [N,3] float32 0..1) sorted by point id."""
    items = sorted(points3d.values(), key=lambda p: p.id)
    xyz = np.stack([p.xyz for p in items]).astype(np.float32)
    rgb = np.stack([p.rgb for p in items]).astype(np.float32) / 255.0
    return xyz, rgb
