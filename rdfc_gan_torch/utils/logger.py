"""Logger to stdout and a file in ``work_dir`` (reference helper.py:79-170;
over ranks, rank 0 alone logs, as the reference's ``get_root_logger``, and
the others only errors), with TensorBoard scalars where ``tensorboard`` is
installed, and the windowed moving average of the train losses
(rdfc_gan_tpu/utils/logger.py:MovingAverage)."""

from __future__ import annotations

import logging
import os
from collections import deque
from typing import Dict, Optional

from ..parallel import is_main


class MovingAverage:
    """Windowed moving average over dicts of scalar losses."""

    def __init__(self, window: int = 100):
        self.window = window
        self._buffers: Dict[str, deque] = {}

    def update(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self._buffers.setdefault(k, deque(maxlen=self.window)).append(
                float(v))

    def mean(self) -> Dict[str, float]:
        return {k: sum(b) / max(len(b), 1) for k, b in self._buffers.items()}


class Logger:
    def __init__(self, work_dir: Optional[str] = None,
                 name: str = "rdfc_gan_torch", filename: str = "test.log"):
        self.logger = logging.getLogger(name)
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.work_dir = work_dir
        # the TensorBoard writer, made at the first add_scalars; False where
        # tensorboard does not import
        self.tb = None
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if not is_main():
            sh.setLevel(logging.ERROR)
            return
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(work_dir, filename))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def log(self, msg: str):
        self.logger.info(msg)

    def error(self, msg: str):
        self.logger.error(msg)

    def add_scalars(self, stats: Dict[str, float], step: int,
                    prefix: str = "train"):
        """Each stat as the scalar ``{prefix}/{name}`` at ``step``, in
        ``work_dir/tf_logs`` (the JAX Logger's TensorBoard directory), on
        the main rank; a no-op elsewhere, without a work_dir, or where
        ``torch.utils.tensorboard`` does not import."""
        if self.tb is None:
            self.tb = False
            if is_main() and self.work_dir:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    return
                self.tb = SummaryWriter(os.path.join(self.work_dir,
                                                     "tf_logs"))
        if self.tb:
            for k, v in stats.items():
                self.tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        if self.tb:
            self.tb.close()
        self.tb = None
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
