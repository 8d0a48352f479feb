"""Context-manager timer (port of rdfc_gan_tpu/utils/timer.py;
reference lib/utils/timer.py:11-30)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, name: str = "", print_on_exit: bool = False):
        self.name = name
        self.print_on_exit = print_on_exit
        self.elapsed = 0.0
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self.print_on_exit:
            print(f"[{self.name}] {self.elapsed:.4f}s")
        return False

    def start(self):
        self._start = time.perf_counter()

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self._start
        return self.elapsed
