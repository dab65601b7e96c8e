"""System utilities. Port of ``aip_tpu.utils.system``.

Parity with reference `utils/system_utils.py` (mkdir_p, searchForMaxIteration)
and `utils/general_utils.py:112-133` safe_state (timestamped stdout lines +
deterministic seeding).
"""

from __future__ import annotations

import os
import random
import re
import sys
from datetime import datetime
from errno import EEXIST


def mkdir_p(folder_path: str) -> None:
    try:
        os.makedirs(folder_path)
    except OSError as exc:
        if exc.errno == EEXIST and os.path.isdir(folder_path):
            pass
        else:
            raise


def search_for_max_iteration(folder) -> int:
    """Latest saved iteration in a checkpoint dir (system_utils.py:26-28):
    filenames like ``iteration_<N>`` / ``ours_<N>`` / ``chkpnt<N>``."""
    best = -1
    for name in os.listdir(folder):
        m = re.search(r"(\d+)", name)
        if m:
            best = max(best, int(m.group(1)))
    return best


class _TimestampedStream:
    def __init__(self, stream, silent: bool):
        self.stream = stream
        self.silent = silent

    def write(self, x: str):
        if self.silent:
            return
        if x.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            self.stream.write(x.replace("\n", f" [{stamp}]\n"))
        else:
            self.stream.write(x)

    def flush(self):
        self.stream.flush()


def safe_state(silent: bool = False, seed: int = 0) -> None:
    """Timestamp every stdout line; seed python, numpy and torch (its CPU
    and every card's generator) (general_utils.py:112-133)."""
    sys.stdout = _TimestampedStream(sys.stdout, silent)
    random.seed(seed)
    import numpy as np
    import torch

    np.random.seed(seed)
    torch.manual_seed(seed)
