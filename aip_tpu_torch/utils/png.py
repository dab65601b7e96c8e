"""PNG files from filtered scanlines: the PNG writer's host half.

``write(path, rows, bit_depth, colour, level)`` writes the [H, 1 + L] uint8
filtered scanlines of ``kernels.png_filter`` (each row its filter type
first) as a PNG: the signature, IHDR, one IDAT and IEND, each with its CRC.

The IDAT holds one zlib stream deflated in strips across host threads
(Python's ``zlib`` lets go of the interpreter lock while it deflates). The
strips are whole rows, about ``STRIP_BYTES`` of filtered bytes each, cut by
the shape alone. Each is deflated raw at ``level``, primed with the 32 KiB
before it (``zdict``: the window one deflate of the whole stream would
have), and ended with a sync flush (an empty stored block that leaves it
byte-aligned), the last with the final block. The strips join behind one
zlib header and end with the adler32 of the whole stream. So the file's
bytes follow from the rows and the level alone, never from the number of
threads or the machine, and the file is within about 1 % of one deflate's
size. The strips run on one thread pool a process, of as many threads as
the process may use cores (``os.sched_getaffinity``).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import Executor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOUR = {1: 0, 3: 2, 4: 6}      # channels -> PNG colour type (grey, RGB, RGBA)
STRIP_BYTES = 128 * 1024
WINDOW = 32 * 1024

_pool: tuple[int, ThreadPoolExecutor] | None = None
_pool_lock = threading.Lock()


def _threads() -> Executor:
    """The process's deflate pool, made anew in a child after a fork (its
    threads do not survive one)."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
                else os.cpu_count() or 1
            _pool = (os.getpid(), ThreadPoolExecutor(cores, thread_name_prefix="png-deflate"))
        return _pool[1]


def strips(height: int, row_bytes: int) -> list[tuple[int, int]]:
    """The (first row, end row) of each strip of a [height, row_bytes]
    stream: ``STRIP_BYTES`` // ``row_bytes`` rows each (at least one)."""
    step = max(1, STRIP_BYTES // row_bytes)
    return [(r, min(r + step, height)) for r in range(0, height, step)]


def _deflate(stream: memoryview, start: int, end: int, level: int, last: bool) -> bytes:
    if start:
        c = zlib.compressobj(level, zlib.DEFLATED, -15, zdict=stream[max(0, start - WINDOW):start])
    else:
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
    return c.compress(stream[start:end]) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def zlib_header(level: int) -> bytes:
    """The two bytes zlib's deflate writes at ``level``: a 32 KiB window and
    the level's FLEVEL, checked to a multiple of 31."""
    flevel = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
    head = (0x78 << 8) | (flevel << 6)
    return struct.pack(">H", head + 31 - head % 31)


def deflate(rows: np.ndarray, level: int, executor: Executor | None = None) -> bytes:
    """The zlib stream of ``rows`` ([H, row bytes] uint8, C-contiguous) at
    ``level`` (0-9), deflated in strips on ``executor`` (the process's
    pool when None)."""
    if not 0 <= level <= 9:
        raise ValueError(f"level must be 0-9, got {level}")
    rows = np.ascontiguousarray(rows, np.uint8)
    stream = memoryview(rows.reshape(-1))
    bounds = [(a * rows.shape[1], b * rows.shape[1]) for a, b in strips(*rows.shape)]
    pool = executor or _threads()
    futures = [pool.submit(_deflate, stream, a, b, level, i == len(bounds) - 1)
               for i, (a, b) in enumerate(bounds)]
    check = struct.pack(">I", zlib.adler32(stream))
    return b"".join([zlib_header(level), *(f.result() for f in futures), check])


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(data, zlib.crc32(tag)))


def encode(rows: np.ndarray, bit_depth: int, channels: int, level: int,
           executor: Executor | None = None) -> bytes:
    """The PNG file of the filtered ``rows`` [H, 1 + W * channels *
    bit_depth / 8] of a ``channels``-channel image (1 grey, 3 RGB, 4 RGBA)
    of ``bit_depth`` 8 or 16 bits a sample, deflated at ``level``."""
    if bit_depth not in (8, 16) or channels not in COLOUR or (bit_depth == 16 and channels != 1):
        raise ValueError(f"the writer takes 8-bit grey, RGB or RGBA and 16-bit grey, got "
                         f"{bit_depth}-bit with {channels} channels")
    h, n = rows.shape
    pixel = channels * bit_depth // 8
    if h < 1 or n < 1 + pixel or (n - 1) % pixel:
        raise ValueError(f"rows [{h}, {n}] are no filtered rows of {pixel}-byte pixels")
    ihdr = struct.pack(">IIBBBBB", (n - 1) // pixel, h, bit_depth, COLOUR[channels], 0, 0, 0)
    return b"".join([SIGNATURE, _chunk(b"IHDR", ihdr),
                     _chunk(b"IDAT", deflate(rows, level, executor)), _chunk(b"IEND", b"")])


def write(path, rows: np.ndarray, bit_depth: int, channels: int, level: int) -> None:
    """``encode`` into the file ``path``."""
    Path(path).write_bytes(encode(rows, bit_depth, channels, level))
