"""Logger to stdout and a file in ``work_dir`` (reference helper.py:79-170;
over ranks, rank 0 alone logs, as the reference's ``get_root_logger``), and
the windowed moving average of the train losses
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
        if not is_main():
            self.logger.addHandler(logging.NullHandler())
            return
        fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        self.logger.addHandler(sh)
        if work_dir:
            os.makedirs(work_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(work_dir, filename))
            fh.setFormatter(fmt)
            self.logger.addHandler(fh)

    def log(self, msg: str):
        self.logger.info(msg)

    def close(self):
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
