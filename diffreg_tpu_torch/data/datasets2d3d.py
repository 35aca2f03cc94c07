"""RGB-D Scenes V2 / 7Scenes image <-> cloud pair readers.

Counterpart of the JAX package's data/datasets2d3d.py (the reference's
RGBDScenes2D3DHardPairDataset and its 7Scenes twin): pkl metadata, per-scene
camera-intrinsics.txt, the depth and colour PNGs cropped to the top-left
476 x 630, the cloud capped at 30k points, small-SE(3) augmentation of the
cloud with the transform composed, and the gray image's mean removed. Emits
raw dicts for ``collate2d3d.build_2d3d_sample``.

The PNGs are decoded here with zlib and numpy (8- and 16-bit gray, 8-bit
RGB: the datasets' depth and colour images), so that the package needs no
image library; the gray conversion is OpenCV's fixed-point BGR2GRAY.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}                 # PNG colour type (gray, RGB) -> samples per pixel


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters -> [height, stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(height):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += stride + 1
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:          # Sub: a running sum, modulo 256, per byte of a pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:          # Up
            cur = row + prev
        elif ftype in (3, 4):     # Average, Paeth: each byte needs the one left of it
            cur = bytearray(row.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} is not defined")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8- or 16-bit gray or RGB PNG -> [H, W] or [H, W, 3]
    uint8 / uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (colour type {ctype}, bit depth {depth}, "
                         f"interlace {interlace})")
    channels, nbytes = _CHANNELS[ctype], depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * channels * nbytes,
                     channels * nbytes)
    img = rows.view(">u2").astype(np.uint16) if nbytes == 2 else rows
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """8-bit RGB [..., 3] -> gray with OpenCV's fixed-point BGR2GRAY rounding:
    (R 9798 + G 19235 + B 3735 + 2^14) >> 15, the 15-bit coefficients of its
    vectorised path (the older 14-bit form, 4899 / 9617 / 1868, differs from
    it on about 0.3% of random pixels)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + 16384) >> 15).astype(np.uint8)


def read_depth_image(path: str, depth_scale: float = 1000.0) -> np.ndarray:
    """A gray (16- or 8-bit) depth PNG -> float32 metres."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    depth = read_png(path)
    if depth.ndim != 2:
        raise ValueError(f"{path}: a depth image must be single-channel gray")
    return depth.astype(np.float32) / depth_scale


def _read_rgb8(path: str) -> np.ndarray:
    """An 8-bit gray or RGB PNG -> uint8 RGB [H, W, 3]."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    img = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: a colour image must have 8-bit samples")
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def read_image(path: str, as_gray: bool = False) -> np.ndarray:
    """An 8-bit PNG -> float32 in [0, 1]: RGB [H, W, 3], or gray [H, W]."""
    rgb = _read_rgb8(path)
    return (rgb_to_gray(rgb) if as_gray else rgb).astype(np.float32) / 255.0


def _random_small_transform(rng: np.random.RandomState, max_deg=5.0, max_trn=0.05):
    from scipy.spatial.transform import Rotation

    euler = (rng.rand(3) - 0.5) * 2 * np.deg2rad(max_deg)
    m = np.eye(4)
    m[:3, :3] = Rotation.from_euler("zyx", euler).as_matrix()
    m[:3, 3] = (rng.rand(3) - 0.5) * 2 * max_trn
    return m


class RGBDScenes2D3DPairDataset:
    """subset pkl -> {scene_name, overlap, intrinsics, transform, image,
    image_gray, depth, points, feats}."""

    crop_hw = (476, 630)
    metadata_fmt = "{subset}.pkl"

    def __init__(self, dataset_dir: str, subset: str, *, max_points: Optional[int] = 30000,
                 scene_name: Optional[str] = None, overlap_threshold: Optional[float] = None,
                 use_augmentation: bool = False, augmentation_noise: float = 0.005,
                 seed: int = 0):
        self.data_dir = os.path.join(dataset_dir, "data")
        meta = os.path.join(dataset_dir, "metadata", self.metadata_fmt.format(subset=subset))
        with open(meta, "rb") as f:
            self.metadata = pickle.load(f)
        if scene_name is not None:
            self.metadata = [m for m in self.metadata if m["scene_name"] == scene_name]
        if overlap_threshold is not None:
            self.metadata = [m for m in self.metadata if m["overlap"] >= overlap_threshold]
        self.max_points = max_points
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.metadata)

    def scene_names(self):
        return sorted({m["scene_name"] for m in self.metadata})

    def __getitem__(self, index: int) -> dict:
        m = self.metadata[index]
        intrinsics = np.loadtxt(os.path.join(
            self.data_dir, m["scene_name"], "camera-intrinsics.txt")).astype(np.float32)
        transform = np.asarray(m["cloud_to_image"], np.float32)
        depth = read_depth_image(os.path.join(self.data_dir, m["depth_file"]))
        rgb = _read_rgb8(os.path.join(self.data_dir, m["image_file"]))
        image = rgb.astype(np.float32) / 255.0
        gray = rgb_to_gray(rgb).astype(np.float32) / 255.0
        ch, cw = self.crop_hw
        depth, image, gray = depth[:ch, :cw], image[:ch, :cw], gray[:ch, :cw]

        points = np.load(os.path.join(self.data_dir, m["cloud_file"])).astype(np.float32)
        if self.max_points and len(points) > self.max_points:
            points = points[self.rng.permutation(len(points))[: self.max_points]]
        if self.use_augmentation:
            aug = _random_small_transform(self.rng)
            center = points.mean(axis=0)
            full = np.eye(4)
            full[:3, 3] = center
            full = full @ aug
            full[:3, 3] -= aug[:3, :3] @ center       # rotate about the centroid
            points = points @ full[:3, :3].T + full[:3, 3]
            inv = np.eye(4)
            inv[:3, :3] = full[:3, :3].T
            inv[:3, 3] = -full[:3, :3].T @ full[:3, 3]
            transform = (transform @ inv).astype(np.float32)
            points = points + (self.rng.rand(*points.shape).astype(np.float32) - 0.5) \
                * self.aug_noise
        gray = gray - gray.mean()
        return {
            "scene_name": m["scene_name"],
            "overlap": m.get("overlap", 1.0),
            "intrinsics": intrinsics,
            "transform": transform,
            "image": image.astype(np.float32),
            "image_gray": gray.astype(np.float32),
            "depth": depth.astype(np.float32),
            "points": points.astype(np.float32),
            "feats": np.ones((len(points), 1), np.float32),
        }


class SevenScenes2D3DPairDataset(RGBDScenes2D3DPairDataset):
    """7Scenes: the same layout and crop; the metadata list is
    ``{subset}-full.pkl``."""

    metadata_fmt = "{subset}-full.pkl"
