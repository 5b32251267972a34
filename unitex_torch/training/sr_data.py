"""Paired SR training data (port of the paired-image part of
unitex_tpu/training/sr_data.py; basicsr ``data/`` semantics): the random
flips and transpose, the aligned GT/LQ crop, GT/LQ path pairing from
folders or a meta file, ``PairedImageDataset`` over the disk and packed
backends, and the batch iterator.

Host side, numpy only: samples are HWC float32 arrays in [0, 1], drawn
from a ``numpy.random.Generator`` in the JAX package's order, so the same
seed gives the same crops and flips in both packages.  The GT-only
(``GTImageDataset``) and video datasets are not ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..utils.file_client import FileClient, paths_from_meta_info, scandir
from ..utils.image_io import imfrombytes


def augment(imgs, rng: np.random.Generator, hflip: bool = True,
            rotation: bool = True, flows=None, return_status: bool = False):
    """Random horizontal flip, vertical flip and transpose, each with p =
    0.5 (``rotation`` enables the last two), the same for every image of
    ``imgs`` (one array or a list).  Flow maps get the matching sign
    flips and dx/dy swap."""
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rotation and rng.random() < 0.5
    do_rot = rotation and rng.random() < 0.5

    def _aug(img):
        if do_hflip:
            img = img[:, ::-1, :]
        if do_vflip:
            img = img[::-1, :, :]
        if do_rot:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    def _aug_flow(flow):
        if do_hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] = -flow[:, :, 0]
        if do_vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] = -flow[:, :, 1]
        if do_rot:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    single = not isinstance(imgs, list)
    out = [_aug(i) for i in ([imgs] if single else imgs)]
    out = out[0] if single else out
    results = [out]
    if flows is not None:
        fsingle = not isinstance(flows, list)
        fout = [_aug_flow(f) for f in ([flows] if fsingle else flows)]
        results.append(fout[0] if fsingle else fout)
    if return_status:
        results.append((do_hflip, do_vflip, do_rot))
    return results[0] if len(results) == 1 else tuple(results)


def paired_random_crop_np(rng: np.random.Generator, gts, lqs,
                          gt_patch: int, scale: int):
    """Aligned random crop: an LQ patch of ``gt_patch // scale`` and the GT
    patch ``scale`` times larger at the same place; single images or
    lists."""
    gsingle = not isinstance(gts, list)
    lsingle = not isinstance(lqs, list)
    gt_list = [gts] if gsingle else gts
    lq_list = [lqs] if lsingle else lqs
    lq_patch = gt_patch // scale
    h_lq, w_lq = lq_list[0].shape[:2]
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(
            f"LQ ({h_lq}, {w_lq}) is smaller than patch {lq_patch}")
    top = int(rng.integers(0, h_lq - lq_patch + 1))
    left = int(rng.integers(0, w_lq - lq_patch + 1))
    lq_out = [v[top:top + lq_patch, left:left + lq_patch, ...]
              for v in lq_list]
    gt_out = [v[top * scale:top * scale + gt_patch,
                left * scale:left * scale + gt_patch, ...]
              for v in gt_list]
    return (gt_out[0] if gsingle else gt_out,
            lq_out[0] if lsingle else lq_out)


def paired_paths_from_folders(lq_folder: str, gt_folder: str,
                              filename_tmpl: str = "{}"
                              ) -> List[Dict[str, str]]:
    """Pairs by GT file name: the LQ name is ``filename_tmpl.format(stem)``
    plus the GT's extension; a missing LQ file raises."""
    gt_names = sorted(scandir(gt_folder))
    paths = []
    for name in gt_names:
        stem, ext = os.path.splitext(os.path.basename(name))
        lq_name = filename_tmpl.format(stem) + ext
        lq_path = os.path.join(lq_folder, lq_name)
        if not os.path.exists(lq_path):
            raise FileNotFoundError(f"{lq_path} is not in lq folder")
        paths.append({"lq_path": lq_path,
                      "gt_path": os.path.join(gt_folder, name)})
    return paths


def paired_paths_from_meta_info_file(lq_folder: str, gt_folder: str,
                                     meta_info_file: str,
                                     filename_tmpl: str = "{}"
                                     ) -> List[Dict[str, str]]:
    """Pairs from the GT names of a meta file (its first token a line)."""
    with open(meta_info_file) as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]
    paths = []
    for name in gt_names:
        stem, ext = os.path.splitext(os.path.basename(name))
        lq_name = filename_tmpl.format(stem) + ext
        paths.append({"lq_path": os.path.join(lq_folder, lq_name),
                      "gt_path": os.path.join(gt_folder, name)})
    return paths


@dataclasses.dataclass(frozen=True)
class PairedImageConfig:
    lq_folder: str
    gt_folder: str
    scale: int = 4
    phase: str = "train"              # train: crop + augment; val: as is
    gt_size: int = 128
    use_hflip: bool = True
    use_rot: bool = True
    filename_tmpl: str = "{}"
    backend: str = "disk"             # 'disk' | 'packed'
    meta_info_file: Optional[str] = None
    seed: int = 0


class PairedImageDataset:
    """GT/LQ pairs (basicsr ``PairedImageDataset``): in the train phase a
    random aligned crop then flips, drawn from the dataset's own
    generator (seeded by ``cfg.seed``); in the val phase the GT cropped
    to the LQ's reach."""

    def __init__(self, cfg: PairedImageConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if cfg.backend == "packed":
            self.client = FileClient(
                "packed", db_paths=[cfg.lq_folder, cfg.gt_folder],
                client_keys=["lq", "gt"])
            keys = paths_from_meta_info(cfg.gt_folder)
            self.paths = [{"lq_path": k, "gt_path": k} for k in keys]
        else:
            self.client = FileClient("disk")
            if cfg.meta_info_file:
                self.paths = paired_paths_from_meta_info_file(
                    cfg.lq_folder, cfg.gt_folder, cfg.meta_info_file,
                    cfg.filename_tmpl)
            else:
                self.paths = paired_paths_from_folders(
                    cfg.lq_folder, cfg.gt_folder, cfg.filename_tmpl)

    def __len__(self) -> int:
        return len(self.paths)

    def _read(self, path: str, client_key: str) -> np.ndarray:
        return imfrombytes(self.client.get(path, client_key))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rec = self.paths[idx]
        gt = self._read(rec["gt_path"], "gt")
        lq = self._read(rec["lq_path"], "lq")
        if cfg.phase == "train":
            gt, lq = paired_random_crop_np(self.rng, gt, lq, cfg.gt_size,
                                           cfg.scale)
            gt, lq = augment([gt, lq], self.rng, cfg.use_hflip, cfg.use_rot)
        else:
            h, w = lq.shape[:2]
            gt = gt[:h * cfg.scale, :w * cfg.scale, :]
        return {"lq": lq.astype(np.float32), "gt": gt.astype(np.float32),
                "lq_path": rec["lq_path"], "gt_path": rec["gt_path"]}


def batch_iterator(dataset, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True, drop_last: bool = True,
                   keys: Sequence[str] = ("lq", "gt")
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of batches, each sample dict's ``keys`` stacked."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        if len(chunk) < batch_size and drop_last:
            return
        samples = [dataset[int(i)] for i in chunk]
        yield {k: np.stack([s[k] for s in samples]) for k in keys}
