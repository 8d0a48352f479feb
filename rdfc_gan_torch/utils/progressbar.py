"""Terminal progress bar with FPS/ETA (port of
rdfc_gan_tpu/utils/progressbar.py; reference lib/utils/progressbar.py)."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, task_num: int = 0, bar_width: int = 50,
                 stream=sys.stdout):
        self.task_num = task_num
        self.bar_width = bar_width
        self.stream = stream
        self.completed = 0
        self.start_time = time.time()

    def update(self, n: int = 1):
        self.completed += n
        elapsed = max(time.time() - self.start_time, 1e-8)
        fps = self.completed / elapsed
        if self.task_num > 0:
            pct = self.completed / self.task_num
            eta = int(elapsed * (1 - pct) / max(pct, 1e-8))
            filled = int(self.bar_width * pct)
            bar = ">" * filled + " " * (self.bar_width - filled)
            self.stream.write(
                f"\r[{bar}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed)}s, ETA: {eta:5}s")
        else:
            self.stream.write(
                f"\rcompleted: {self.completed}, elapsed: {int(elapsed)}s, "
                f"{fps:.1f} tasks/s")
        if self.task_num and self.completed >= self.task_num:
            self.stream.write("\n")
        self.stream.flush()
