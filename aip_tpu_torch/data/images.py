"""Image dataset and endless batch sampling for the trainers. Port of
``aip_tpu.data.images``: numpy and PIL only.

Parity with reference ``AdaIN/train.py:20-45`` (FlatFolderDataset: a flat
glob of a directory, resize to 512x512, random-crop 256, [0,1] float) and
``AdaIN/sampler.py`` InfiniteSamplerWrapper (an endless shuffled index
stream).

Batches come out as contiguous NHWC float32 numpy arrays. One difference
from the JAX package, on purpose: with ``num_workers > 1`` the JAX pool's
tasks each take the shared generator's lock, so a batch's (index, seed)
pairs can land in its slots in another order from run to run. Here the
assembler draws a batch's pairs in order and only the decoding goes to the
pool, so every ``num_workers`` gives the JAX package's ``num_workers=1``
stream, batch for batch.
"""

from __future__ import annotations

import threading
from pathlib import Path
from queue import Queue

import numpy as np


def train_transform(img, rng: np.random.Generator, resize=(512, 512), crop=256):
    """Resize to 512x512 then random-crop 256 (train.py:20-26)."""
    from PIL import Image

    img = img.resize(resize, Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    h, w, _ = arr.shape
    top = int(rng.integers(0, h - crop + 1))
    left = int(rng.integers(0, w - crop + 1))
    return arr[top:top + crop, left:left + crop]


class FlatFolderDataset:
    """Flat directory of images (train.py:29-45)."""

    IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

    def __init__(self, root):
        self.root = Path(root)
        self.paths = sorted(
            p for p in self.root.glob("*") if p.suffix.lower() in self.IMG_EXTS
        )
        if not self.paths:
            raise ValueError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def load(self, index, rng, crop=256):
        from PIL import Image

        img = Image.open(str(self.paths[index])).convert("RGB")
        return train_transform(img, rng, crop=crop)


def infinite_batches(dataset: FlatFolderDataset, batch_size: int, seed: int = 0,
                     crop: int = 256, prefetch: int = 2, num_workers: int = 8):
    """Endless shuffled batches [B, crop, crop, 3] float32.

    One assembler thread draws each sample's (index, seed) in stream order
    and emits batches in order, ``prefetch`` batches ahead of the consumer;
    with ``num_workers > 1`` a thread pool decodes a batch's samples in
    parallel (PIL's codecs release the GIL). An image that fails to decode
    raises its error here, in the consumer."""
    rng = np.random.default_rng(seed)

    def index_stream():
        while True:
            for i in rng.permutation(len(dataset)):
                yield int(i)

    idx_iter = index_stream()

    def next_pair():
        # The same draws, in the same order, as the JAX package's
        # single-worker stream: the index, then the sample's seed.
        i = next(idx_iter)
        return i, np.random.default_rng(rng.integers(1 << 63))

    def decode(pair):
        return dataset.load(pair[0], pair[1], crop)

    q: Queue = Queue(maxsize=prefetch)
    if num_workers <= 1:
        def assembler():
            while True:
                q.put(np.stack([decode(next_pair()) for _ in range(batch_size)]))
    else:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=num_workers)

        def assembler():
            while True:
                pairs = [next_pair() for _ in range(batch_size)]
                q.put(np.stack(list(pool.map(decode, pairs))))

    def run():
        try:
            assembler()
        except Exception as exc:  # a sample that fails to decode reaches the consumer
            q.put(exc)

    threading.Thread(target=run, daemon=True).start()
    while True:
        batch = q.get()
        if isinstance(batch, Exception):
            raise batch
        yield batch
