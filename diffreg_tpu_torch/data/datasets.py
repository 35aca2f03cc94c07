"""Dataset readers: 3DMatch (Predator pkl splits) and 4DMatch (npz entries).

Counterpart of the JAX package's data/datasets.py (the reference
datasets/_3dmatch.py:15-135 and _4dmatch.py:58-146): readers that return raw
pair dicts, and ``iterate_batches``, which builds each pair's pyramid in a
thread pool and groups the pairs into ``PairBatch``es per shape bucket,
from this process's shard of the epoch in a data-parallel run.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Iterator, Optional

import numpy as np
import torch


def _load_cloud(path: str) -> np.ndarray:
    """A point cloud saved as a torch tensor (.pth/.pt) or .npy."""
    if path.endswith((".pth", ".pt")):
        return np.asarray(torch.load(path, map_location="cpu", weights_only=True),
                          dtype=np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    raise ValueError(f"unsupported cloud format: {path}")


def _random_so3(rng: np.random.RandomState, rot_factor: float = 1.0) -> np.ndarray:
    """Rotation from zyx Euler angles uniform in [0, 2 pi / rot_factor)
    (the reference augmentation, _3dmatch.py:95-96)."""
    from scipy.spatial.transform import Rotation

    euler = rng.rand(3) * 2.0 * np.pi / rot_factor
    return Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)


class ThreeDMatchPairDataset:
    """Predator-format split: a pkl of rot / trans / src / tgt [/ gt_cov] lists
    and the cloud files under ``data_root``. Items are dicts (src_pcd, tgt_pcd,
    rot, trn, gt_cov, scene_flow=None, metric_index=None). Augmentation
    (_3dmatch.py:93-106): a random rotation of one side and uniform noise."""

    def __init__(self, info_path: str, data_root: str, *, augment: bool = False,
                 augment_noise: float = 0.005, max_points: int = 30000,
                 rot_factor: float = 1.0, seed: int = 0):
        # a split file of the dataset itself, as the reference reads it
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        self.data_root = data_root
        self.augment = augment
        self.augment_noise = augment_noise
        self.max_points = max_points
        self.rot_factor = rot_factor
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos["rot"])

    def __getitem__(self, item: int) -> dict:
        rot = np.asarray(self.infos["rot"][item], np.float32)
        trn = np.asarray(self.infos["trans"][item], np.float32).reshape(3, 1)
        gt_cov = None
        if self.infos.get("gt_cov") is not None:
            gt_cov = np.asarray(self.infos["gt_cov"][item], np.float32)
        src = _load_cloud(os.path.join(self.data_root, self.infos["src"][item]))
        tgt = _load_cloud(os.path.join(self.data_root, self.infos["tgt"][item]))
        if len(src) > self.max_points:
            src = src[self.rng.permutation(len(src))[:self.max_points]]
        if len(tgt) > self.max_points:
            tgt = tgt[self.rng.permutation(len(tgt))[:self.max_points]]
        if self.augment:
            rot_ab = _random_so3(self.rng, self.rot_factor)
            if self.rng.rand() > 0.5:
                src = src @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                tgt = tgt @ rot_ab.T
                rot = rot_ab @ rot
                trn = rot_ab @ trn
            src = src + (self.rng.rand(*src.shape).astype(np.float32) - 0.5) * self.augment_noise
            tgt = tgt + (self.rng.rand(*tgt.shape).astype(np.float32) - 0.5) * self.augment_noise
        return {"src_pcd": src.astype(np.float32), "tgt_pcd": tgt.astype(np.float32),
                "rot": rot, "trn": trn, "gt_cov": gt_cov, "scene_flow": None,
                "metric_index": None}


class FourDMatchPairDataset:
    """4DMatch: a directory of .npz entries with the source and target clouds,
    ``s2t_flow``, ``rot``, ``trans`` and ``metric_index``. Augmentation
    (_4dmatch.py:109-123): a random rotation of one side, uniform noise, and
    the flow re-derived from the rotated deformed source."""

    def __init__(self, split_dir: str, *, augment: bool = False, augment_noise: float = 0.002,
                 max_points: int = 30000, rot_factor: float = 1.0, seed: int = 0):
        self.entries = sorted(glob.glob(os.path.join(split_dir, "**", "*.npz"), recursive=True))
        self.augment = augment
        self.augment_noise = augment_noise
        self.max_points = max_points
        self.rot_factor = rot_factor
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, item: int) -> dict:
        with np.load(self.entries[item]) as z:
            def pick(*names):
                return next((z[n] for n in names if n in z), None)

            # reference entries name the clouds s_pc / t_pc (_4dmatch.py:73-74)
            src = pick("s_pc", "src_pcd_list", "src_pcd")
            tgt = pick("t_pc", "tgt_pcd_list", "tgt_pcd")
            flow, rot, trn = pick("s2t_flow"), pick("rot"), pick("trans")
            metric_index = pick("metric_index")
        src = np.asarray(src, np.float32)
        tgt = np.asarray(tgt, np.float32)
        flow = np.zeros_like(src) if flow is None else np.asarray(flow, np.float32)
        rot = np.eye(3, dtype=np.float32) if rot is None else np.asarray(rot, np.float32)
        trn = np.zeros((3, 1), np.float32) if trn is None \
            else np.asarray(trn, np.float32).reshape(3, 1)
        if len(src) > self.max_points:
            keep = self.rng.permutation(len(src))[:self.max_points]
            src, flow = src[keep], flow[keep]
        if len(tgt) > self.max_points:
            tgt = tgt[self.rng.permutation(len(tgt))[:self.max_points]]
        if self.augment:
            deformed = src + flow
            rot_ab = _random_so3(self.rng, self.rot_factor)
            if self.rng.rand() > 0.5:
                src = src @ rot_ab.T
                deformed = deformed @ rot_ab.T
                rot = rot @ rot_ab.T
            else:
                tgt = tgt @ rot_ab.T
                rot = rot_ab @ rot
                trn = rot_ab @ trn
            src = src + (self.rng.rand(*src.shape).astype(np.float32) - 0.5) * self.augment_noise
            tgt = tgt + (self.rng.rand(*tgt.shape).astype(np.float32) - 0.5) * self.augment_noise
            flow = deformed - src
        return {"src_pcd": src, "tgt_pcd": tgt, "rot": rot, "trn": trn, "gt_cov": None,
                "scene_flow": flow,
                "metric_index": None if metric_index is None
                else np.asarray(metric_index, np.int64).squeeze()}


def iterate_batches(dataset, spec, pyr_cfg, batch_size: int, *, shuffle=False, seed=0,
                    drop_last=False, num_workers: int = 1, prefetch: int = 2,
                    stats: Optional[dict] = None, process_index: int = 0,
                    process_count: int = 1) -> Iterator:
    """Yield (PairBatch of CPU tensors, raw pair dicts) per batch.

    ``spec`` is one ShapeSpec or a list of buckets (small to large): each pair
    goes to the smallest bucket it fits, and a bucket yields a batch when it
    fills (then the rest at the end, unless ``drop_last``). ``num_workers`` > 1
    builds pyramids in a thread pool, ``prefetch`` batches ahead. ``stats``
    receives ``pairs_dropped`` (pairs too large for every bucket) and
    ``pairs_used``. ``process_index`` / ``process_count`` shard the
    (identically shuffled) epoch order over the processes, DistributedSampler
    style (``parallel.distributed.shard_order_for_process``): each process
    builds its own shard (reference Diff-Reg-3dmatch/main.py:127)."""
    from .loader import parallel_map_iter, prefetch_iter
    from .pyramid import batch_from_samples, build_pair_pyramid

    specs = list(spec) if isinstance(spec, (list, tuple)) else [spec]
    stats = {} if stats is None else stats
    stats.setdefault("pairs_dropped", 0)
    stats.setdefault("pairs_used", 0)
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if process_count > 1:
        from ..parallel.distributed import shard_order_for_process

        order = shard_order_for_process(order, process_index, process_count)

    def build_one(i):
        raw = dataset[int(i)]
        for s in specs:
            try:
                return build_pair_pyramid(raw["src_pcd"], raw["tgt_pcd"], raw["rot"],
                                          raw["trn"], pyr_cfg, s,
                                          scene_flow=raw.get("scene_flow"),
                                          gt_cov=raw.get("gt_cov")), s, raw
            except ValueError:      # too large for this bucket
                continue
        return None, None, raw

    def batches():
        bufs = {id(s): ([], []) for s in specs}
        for sample, used, raw in parallel_map_iter(build_one, order, num_workers=num_workers):
            if sample is None:
                stats["pairs_dropped"] += 1
                continue
            stats["pairs_used"] += 1
            samples, metas = bufs[id(used)]
            samples.append(sample)
            metas.append(raw)
            if len(samples) == batch_size:
                yield batch_from_samples(samples), list(metas)
                samples.clear()
                metas.clear()
        if not drop_last:
            for samples, metas in bufs.values():
                if samples:
                    yield batch_from_samples(samples), list(metas)

    it = batches()
    if num_workers > 1 and prefetch > 0:
        it = prefetch_iter(it, buffer_size=prefetch)
    yield from it
