"""Replica / 12-Scenes dataset loaders — same on-disk contract as the
reference (utils/dataset.py:20-481).

A copy of ``splatloc_tpu.data.datasets`` (host-only numpy; the port imports
nothing of the JAX package):

- Replica: Sequence_1 train (every 5th frame), Sequence_2 test; poses from
  traj_w_c.txt (c2w, row-major 4x4 per line); depth uint16 / depth_scale.
- 12-Scenes: split.txt gives the test/train boundary; per-frame
  frame-XXXXXX.{color.jpg,depth.png,pose.txt}; INF poses -> valid=False;
  images resized to 640x480.
- generated_folder artifacts: score_map/{name}_score.npy dense SuperPoint
  saliency, sp_feature/{name}.pt dense descriptors (a torch file),
  sp_inloc_pc.ply + sp_inloc_feat.npy fused cloud.

get_frame returns the reference dict contract with numpy arrays.
"""
from __future__ import annotations

import glob
import os

import numpy as np
from PIL import Image

from splatloc_tpu_torch.data import native_io


def _imread_rgb(path: str, size=None) -> np.ndarray:
    if size is None and path.endswith(".png") and native_io.available():
        with Image.open(path) as probe:
            w, h = probe.size
        arr = native_io.png_read_rgb(path, w, h)
        if arr is not None:
            return arr.astype(np.float32) / 255.0
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != size:
        img = img.resize(size, Image.BILINEAR)
    return np.asarray(img).astype(np.float32) / 255.0


def _imread_depth(path: str, scale: float) -> np.ndarray:
    if path.endswith(".png") and native_io.available():
        with Image.open(path) as probe:
            w, h = probe.size
        arr = native_io.png_read_depth16(path, w, h)
        if arr is not None:
            return arr.astype(np.float32) / scale
    img = Image.open(path)
    arr = np.asarray(img)
    return arr.astype(np.float32) / scale


class _BaseDataset:
    def __init__(self, config: dict, train: bool):
        self.config = config
        self.train = train
        self.input_folder = config["Dataset"]["dataset_path"]
        self.sp_score_thre = 0.005
        self.train_step = 5

        cal = config["Dataset"]["Calibration"]
        self.fx, self.fy = cal["fx"], cal["fy"]
        self.cx, self.cy = cal["cx"], cal["cy"]
        self.width, self.height = cal["width"], cal["height"]
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1]], np.float64)
        self.depth_scale = cal.get("depth_scale", 1000.0)

        self.load_sp_feat_flag = False
        self.load_score_flag = True

    def _set_generated(self, scene_name: str):
        gen = self.config["Dataset"].get("generated_folder", "")
        self.generated_folder = os.path.join(gen, scene_name)
        self.sp_feat_path = os.path.join(self.generated_folder, "sp_feature")
        self.sp_score_path = os.path.join(self.generated_folder, "score_map")
        self.sparse_ply = os.path.join(self.generated_folder,
                                       "sp_inloc_pc.ply")
        self.sparse_feature = os.path.join(self.generated_folder,
                                           "sp_inloc_feat.npy")

    def __len__(self):
        return self.n_img

    def set_feature_flag(self, value: bool):
        self.load_sp_feat_flag = value

    def name_to_index(self, name: str) -> int:
        """Exact extension-stripped basename match (reference
        utils/dataset.py:79-82,307-314 uses substring/exact-with-ext; we
        normalize both sides so 'rgb_5' cannot collide with rgb_50.png)."""
        base = os.path.basename(name).split(".")[0]
        matches = [i for i, p in enumerate(self.color_paths)
                   if os.path.basename(p).split(".")[0] == base]
        assert len(matches) == 1, (name, matches)
        return matches[0]

    def load_kp_feature_score(self, index: int) -> np.ndarray:
        name = self.index_to_name(index)
        return np.load(os.path.join(self.sp_score_path,
                                    f"{name}_score.npy"))

    def load_sp_feat(self, index: int) -> np.ndarray:
        """Dense [H, W, 256] SuperPoint descriptors from the generated
        folder (.pt torch file, reference utils/dataset.py:84-88)."""
        import torch
        name = self.index_to_name(index)
        feat = torch.load(os.path.join(self.sp_feat_path, f"{name}.pt"),
                          map_location="cpu")
        return feat.squeeze().permute(1, 2, 0).contiguous().numpy()

    def load_all_depth(self) -> np.ndarray:
        out = []
        for i in range(self.n_img):
            c2w, valid = self._pose(i)
            if not valid:
                continue
            out.append(self.load_depth(i))
        return np.stack(out)

    def load_all_poses(self, valid_only=True):
        """(c2w [M,4,4], valid [M]) for all frames."""
        poses, valids = [], []
        for i in range(self.n_img):
            c2w, valid = self._pose(i)
            poses.append(c2w)
            valids.append(valid)
        return np.stack(poses), np.asarray(valids)

    def get_frame(self, index: int) -> dict:
        rgb = self.load_image(index)
        depth = self.load_depth(index)
        c2w, valid = self._pose(index)
        ret = {
            "K": self.K,
            "c2w": c2w.astype(np.float32),
            "w2c": np.linalg.inv(c2w).astype(np.float32),
            "rgb": rgb,
            "depth": depth,
            "valid": bool(valid),
            "img_path": self.color_paths[index],
        }
        if self.load_sp_feat_flag and self.train:
            ret["sp_feature"] = self.load_sp_feat(index)
        if self.load_score_flag and self.train:
            score = self.load_kp_feature_score(index)
            ret["sp_kp_score"] = score
            ret["sp_kp_mask"] = (score > self.sp_score_thre).astype(np.int32)
        return ret


class ReplicaDataset(_BaseDataset):
    def __init__(self, config: dict, train: bool = True):
        super().__init__(config, train)
        self.scene_name = self.input_folder.rstrip("/").split("/")[-1]
        self._set_generated(self.scene_name)
        seq = "Sequence_1" if train else "Sequence_2"
        self.color_paths = sorted(
            glob.glob(os.path.join(self.input_folder, seq, "rgb", "*.png")),
            key=lambda x: int(os.path.basename(x)[4:-4]))
        self.depth_paths = sorted(
            glob.glob(os.path.join(self.input_folder, seq, "depth", "*.png")),
            key=lambda x: int(os.path.basename(x)[6:-4]))
        if train:
            self.color_paths = self.color_paths[::self.train_step]
            self.depth_paths = self.depth_paths[::self.train_step]
        self.n_img = len(self.color_paths)
        gt_file = os.path.join(self.input_folder, seq, "traj_w_c.txt")
        poses = np.loadtxt(gt_file, delimiter=" ").reshape(-1, 4, 4)
        self.poses = poses[::self.train_step] if train else poses

    def index_to_name(self, index: int) -> str:
        return os.path.basename(self.color_paths[index])[:-4]

    def _pose(self, index: int):
        c2w = self.poses[index]
        valid = np.isfinite(c2w).all()
        return c2w, valid

    def load_image(self, index: int) -> np.ndarray:
        return _imread_rgb(self.color_paths[index])

    def load_depth(self, index: int) -> np.ndarray:
        return _imread_depth(self.depth_paths[index], self.depth_scale)


class Scenes12Dataset(_BaseDataset):
    def __init__(self, config: dict, train: bool = True):
        super().__init__(config, train)
        parts = self.input_folder.rstrip("/").split("/")
        self.scene_name = parts[-2] + "_" + parts[-1]
        # Reference maps office*->of* when locating generated artifacts
        # (utils/dataset.py:239: scene_name.replace('office', 'of')).
        self._set_generated(self.scene_name.replace("office", "of"))
        split, end = self._parse_split()
        self.split_index = split
        if train:
            ids = [i for i in range(0, end + 1, self.train_step) if i > split]
        else:
            ids = list(range(split + 1))
        self.color_paths = [
            os.path.join(self.input_folder, "data",
                         "frame-{:0>6d}.color.jpg".format(i)) for i in ids]
        self.n_img = len(self.color_paths)

    def _parse_split(self):
        with open(os.path.join(self.input_folder, "split.txt")) as f:
            seqs = f.readlines()
        split = int(seqs[0].replace("\n", "").split("=")[-1][:-1])
        end = int(seqs[-1].replace("\n", "").split("=")[-1][:-1])
        return split, end

    def index_to_name(self, index: int) -> str:
        return os.path.basename(self.color_paths[index]).split(".")[0]

    def _pose(self, index: int):
        name = self.index_to_name(index)
        path = os.path.join(self.input_folder, "data", f"{name}.pose.txt")
        rows = []
        with open(path) as f:
            for line in f:
                if "INF" in line:
                    return np.eye(4), False
                rows.append([float(c) for c in line.strip().split()])
        c2w = np.asarray(rows, np.float32)
        assert c2w.shape == (4, 4)
        return c2w, True

    def load_image(self, index: int) -> np.ndarray:
        return _imread_rgb(self.color_paths[index], size=(640, 480))

    def load_depth(self, index: int) -> np.ndarray:
        name = self.index_to_name(index)
        path = os.path.join(self.input_folder, "data", f"{name}.depth.png")
        return _imread_depth(path, self.depth_scale)


def load_dataset(config: dict, train: bool = True):
    """Factory (reference utils/dataset.py:475-481)."""
    kind = config["Dataset"]["type"]
    if kind == "replica":
        return ReplicaDataset(config, train)
    if kind == "12scenes":
        return Scenes12Dataset(config, train)
    raise ValueError(f"unknown dataset type {kind}")
