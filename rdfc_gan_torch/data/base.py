"""BaseDataset (port of rdfc_gan_tpu/data/base.py; reference
lib/datasets/base.py:12-163): mode dispatch, retry-on-None, the per-sample
generator keyed by (seed, epoch, index), the decoded-sample cache, the v1
``evaluate`` and the debug dumps.

Decoded-sample cache: PNG decode is most of a sample's host cost and the
same every epoch, so datasets route their raw decode through
``_cache_load`` / ``_cache_store``, keyed by the sample's relative path and
stored as uncompressed ``.npz``. Opt-in: ``RDFC_DECODE_CACHE=<dir>`` or the
``decode_cache`` argument. The file name folds a format version, the
dataset class, the data root and any subclass decode parameters into a
salt (the JAX package's rule and version), so a cache shared across
datasets or filled before a decode change misses instead of serving stale
samples.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

from . import cv_ops, image_io


class BaseDataset:
    def __init__(self, data_root: str, mode: str = "train",
                 rgb_mean=(0.485, 0.456, 0.406), rgb_std=(0.229, 0.224, 0.225),
                 max_depth: float = 10.0, depth_mean=(5.0,), depth_std=(5.0,),
                 seed: int = 0, decode_cache: Optional[str] = None):
        if data_root is None:
            raise ValueError(f"{type(self).__name__} needs a data_root "
                             f"(--data_root)")
        self.data_root = data_root
        self.mode = mode
        self.rgb_mean = np.asarray(rgb_mean, np.float32)
        self.rgb_std = np.asarray(rgb_std, np.float32)
        self.max_depth = max_depth
        self.depth_mean = float(np.asarray(depth_mean).reshape(-1)[0])
        self.depth_std = float(np.asarray(depth_std).reshape(-1)[0])
        self.seed = seed
        self.epoch = 0
        self.decode_cache = decode_cache or os.environ.get(
            "RDFC_DECODE_CACHE")
        if self.decode_cache:
            os.makedirs(self.decode_cache, exist_ok=True)

    # bump when any _load_raw decode/preprocess step changes meaning
    _CACHE_FORMAT = 2

    def _cache_salt(self) -> str:
        """Extra decode-affecting parameters; subclasses append theirs."""
        return ""

    def _cache_path(self, rel_key: str) -> str:
        salt = (f"v{self._CACHE_FORMAT}|{type(self).__name__}|"
                f"{os.path.abspath(self.data_root)}|{self._cache_salt()}")
        h = hashlib.sha1(salt.encode()).hexdigest()[:10]
        return os.path.join(self.decode_cache,
                            f"{h}__{rel_key.replace('/', '__')}.npz")

    def _cache_load(self, rel_key: str):
        if not self.decode_cache:
            return None
        try:
            with np.load(self._cache_path(rel_key)) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError, EOFError):
            return None

    def _cache_store(self, rel_key: str, sample: Dict[str, np.ndarray]):
        if not self.decode_cache:
            return
        p = self._cache_path(rel_key)
        try:
            # np.savez appends ".npz" unless the name already ends with it
            tmp = f"{p}.{os.getpid()}.tmp.npz"
            np.savez(tmp, **sample)
            os.replace(tmp, p)
        except OSError:
            pass

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx)

    def _read(self, rel: str) -> np.ndarray:
        """``cv2.imread(data_root/rel, cv2.IMREAD_UNCHANGED)``."""
        return image_io.imread(os.path.join(self.data_root, rel))

    def get_train_data(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def get_test_data(self, idx: int) -> Optional[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def __getitem__(self, idx: int):
        if self.mode == "train":
            sample = self.get_train_data(idx)
            tries = 0
            while sample is None and tries < 10:  # retry-on-None (base.py:70-75)
                idx = int(self._rng(idx).integers(0, len(self)))
                sample = self.get_train_data(idx)
                tries += 1
            return sample
        return self.get_test_data(idx)

    def evaluate(self, results, logger=None):
        """The split's metrics from v1 results (dicts of 'gt', 'pd' and an
        optional 'evaluate_mask'), through ``RDFGANMetric`` (base.py:
        112-115); ``evaluator.EvalV1`` calls it."""
        from ..metrics import RDFGANMetric

        return RDFGANMetric().evaluate_all(results, logger)

    def show(self, samples, iters: int = 0, save_dir: str = ".",
             max_show_num: int = 6):
        """Colormapped per-sample debug dumps (lib/datasets/base.py:103-163):
        un-normalize with the dataset statistics and write
        ``{i}_{rgb,raw_depth,pred_depth,gt_depth,pred_gray}.png`` under
        ``save_dir/{iters:010d}/``. NHWC numpy arrays in, uint8 PNGs out
        (OpenCV's plasma colormap stands in for matplotlib's)."""
        out = os.path.join(save_dir, f"{int(iters):010d}")
        os.makedirs(out, exist_ok=True)
        rgb = np.asarray(samples["rgb"], np.float32)
        rgb = (rgb * self.rgb_std + self.rgb_mean) * 255.0
        deps = {}
        for k in ("raw_depth", "pred_depth", "gt_depth"):
            d = np.asarray(samples[k], np.float32)
            deps[k] = np.clip(
                (d * self.depth_std + self.depth_mean) / self.max_depth,
                0.0, 1.0)
        for i in range(min(rgb.shape[0], max_show_num)):
            image_io.imwrite(os.path.join(out, f"{i}_rgb.png"),
                             np.clip(rgb[i], 0, 255).astype(np.uint8)[..., ::-1])
            for k in ("raw_depth", "pred_depth", "gt_depth"):
                g8 = (255.0 * deps[k][i, ..., 0]).astype(np.uint8)
                image_io.imwrite(os.path.join(out, f"{i}_{k}.png"),
                                 cv_ops.apply_colormap(
                                     g8, cv_ops.COLORMAP_PLASMA))
            g8 = (255.0 * deps["pred_depth"][i, ..., 0]).astype(np.uint8)
            image_io.imwrite(os.path.join(out, f"{i}_pred_gray.png"), g8)
        return out
