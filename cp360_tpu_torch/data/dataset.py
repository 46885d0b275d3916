"""Dataset over stage-1 artifacts + a threaded prefetch loader.

The port's copy of ``cp360_tpu/data/dataset.py`` (reference Sal360Dataset,
data/dataset.py:13-83): windows of ``seq_len`` consecutive CAM cubes and
optical flows from ``<root>/<vid>/cube_feat/NNNNNN.npy`` ([6, C, h, w]) and
``<root>/<vid>/motion/NNNNNN.npy`` ([H, W, 2]), starting at frames with
index < max_index - seq_len + 1 (data/dataset.py:39).  Missing frames raise;
batches are contiguous numpy arrays with the cubes transposed to NHWC and
the artifacts' dtype kept (the train step widens to f32).

Files are read with numpy (the JAX package's native batch loader is not
ported).  The loader's ``transfer_codec`` takes ``none`` only.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def read_split(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def builtin_split(name: str) -> List[str]:
    """The Wild-360 video-id splits shipped with the reference
    (data/test_25.txt, data/train_60.txt)."""
    here = os.path.join(os.path.dirname(__file__), "splits")
    return read_split(os.path.join(here, f"{name}.txt"))


class WindowDataset:
    """Indexable set of (video, start-frame) windows over stage-1 artifacts."""

    def __init__(self, feat_root: str, motion_root: Optional[str],
                 video_ids: Sequence[str], seq_len: int):
        self.feat_root = feat_root
        self.motion_root = motion_root if motion_root is not None else feat_root
        self.seq_len = seq_len
        self.windows: List[Tuple[str, int]] = []  # (video, start frame index)

        for vid in sorted(video_ids):
            feat_dir = os.path.join(feat_root, vid, "cube_feat")
            if not os.path.isdir(feat_dir):
                continue
            # strict NNNN.npy only: stray files are no window starts
            frames = sorted(int(m.group(1)) for m in
                            (re.match(r"(\d+)\.npy$", f) for f in os.listdir(feat_dir)) if m)
            if not frames:
                continue
            max_len = frames[-1]
            self.windows.extend((vid, idx) for idx in frames
                                if idx < max_len - seq_len + 1)

    def __len__(self) -> int:
        return len(self.windows)

    def _frame_path(self, root: str, vid: str, sub: str, idx: int) -> str:
        return os.path.join(root, vid, sub, f"{idx:06}.npy")

    def _load(self, root: str, vid: str, sub: str, idx: int) -> np.ndarray:
        path = self._frame_path(root, vid, sub, idx)
        if not os.path.exists(path):
            kind = "CAM" if sub == "cube_feat" else "flow"
            raise FileNotFoundError(f"missing {kind} frame {path}")
        return np.load(path)

    def __getitem__(self, i: int):
        """Returns (seq [T,6,h,w,C] NHWC, flows [T,H,W,2], vid, start)."""
        vid, start = self.windows[i]
        frames = range(start, start + self.seq_len)
        seq = np.stack([self._load(self.feat_root, vid, "cube_feat", f).transpose(0, 2, 3, 1)
                        for f in frames])
        flow = np.stack([self._load(self.motion_root, vid, "motion", f) for f in frames])
        return seq, flow, vid, start

    def get_batch(self, idxs):
        """(seq [B,T,6,h,w,C], flows [B,T,H,W,2]) for the given windows."""
        items = [self[int(i)] for i in idxs]
        return (np.ascontiguousarray(np.stack([it[0] for it in items])),
                np.stack([it[1] for it in items]))


class PrefetchLoader:
    """Shuffled, batched, background-prefetching iterator over a dataset:
    one worker thread reads the next ``prefetch`` batches while the device
    runs the current one (the reference's DataLoader(num_workers=4),
    temporal_model/train_temporal.py:232-233)."""

    def __init__(self, dataset: WindowDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, transfer_codec: str = "none"):
        if transfer_codec != "none":
            raise NotImplementedError(
                f"transfer_codec={transfer_codec!r} is not ported yet (the int8 codec; "
                'see ROADMAP.md, "trainer options"); use transfer_codec: none')
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size  # a short last batch is dropped

    def iter_epoch(self, epoch: int,
                   skip_batches: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The epoch's batches in an order seeded by ``seed + epoch`` alone,
        so a resumed run replays the order an uninterrupted one would use;
        ``skip_batches`` drops the first k batches without reading them."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        nb = len(self)
        if not 0 <= skip_batches <= nb:
            raise ValueError(f"skip_batches={skip_batches} not in [0, {nb}]")
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(skip_batches, nb)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue put that gives up once the consumer stopped iterating."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for idxs in batches:
                    if stop.is_set() or not put(self.ds.get_batch(idxs)):
                        return
                put(None)
            except Exception as e:  # surfaced to the consumer, raised there
                put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=5)
