"""What the host spent over the measured window: the full collections of
Python's collector (how many, and their seconds on the host clock) and the
process's CPU seconds."""

from __future__ import annotations

import gc
import os
import time


class HostWatch:
    """Counts full collections while the window is open; ``close()``
    takes the callback off the collector."""

    def __init__(self):
        self.full = 0
        self.full_s = 0.0
        self._open = False
        self._t = None
        self._cpu0 = None
        self.cpu_s = None
        gc.callbacks.append(self._collected)

    def _collected(self, phase, info):
        if not self._open or info["generation"] != 2:
            return
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.full += 1
            self.full_s += time.perf_counter() - self._t
            self._t = None

    def window(self, opening: bool) -> None:
        cpu = sum(os.times()[:2])
        if opening:
            self._cpu0 = cpu
        else:
            self.cpu_s = cpu - self._cpu0
        self._open = opening

    def close(self) -> None:
        if self._collected in gc.callbacks:
            gc.callbacks.remove(self._collected)

    def summary(self, window_s: float) -> str:
        return (f"host over the {window_s:.3f} s window: {self.full} full "
                f"collections, {self.full_s:.3f} s; process CPU "
                f"{self.cpu_s:.3f} s")
