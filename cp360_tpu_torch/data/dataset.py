"""Dataset over stage-1 artifacts + a threaded prefetch loader.

The port's copy of ``cp360_tpu/data/dataset.py`` (reference Sal360Dataset,
data/dataset.py:13-83): windows of ``seq_len`` consecutive CAM cubes and
optical flows from ``<root>/<vid>/cube_feat/NNNNNN.npy`` ([6, C, h, w]) and
``<root>/<vid>/motion/NNNNNN.npy`` ([H, W, 2]), starting at frames with
index < max_index - seq_len + 1 (data/dataset.py:39).  Missing frames raise;
batches are contiguous numpy arrays with the cubes transposed to NHWC and
the artifacts' dtype kept (the train step widens to f32).

Files are read with numpy on ``num_threads`` threads (the JAX package's
native batch loader is not ported).  :class:`SegmentWindowDataset` groups
consecutive windows into one frame run (config ``segment_windows``), and
the loader's ``transfer_codec: int8`` ships the CAM windows as int8 plus
f32 scales and the flows as f16.  ``rows`` reads only one rank's span of
every global batch (``parallel/mesh.py::local_rows_slice``).
"""

from __future__ import annotations

import os
import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
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

    def __getitem__(self, i: int):
        """Returns (seq [T,6,h,w,C] NHWC, flows [T,H,W,2], vid, start)."""
        vid, start = self.windows[i]
        seq, flow = self.read_runs([(vid, start)], self.seq_len)
        return seq[0], flow[0], vid, start

    def read_runs(self, runs: Sequence[Tuple[str, int]], n_frames: int, n_threads: int = 0):
        """(seq [R, n_frames, 6, h, w, C], flows [R, n_frames, H, W, 2]) for
        runs of ``n_frames`` consecutive frames starting at each (vid, first
        frame index); files are read on ``n_threads`` threads (0 or 1: on
        the caller's).  A missing file raises before any is read."""
        paths = {"cube_feat": [], "motion": []}
        for vid, start in runs:
            for f in range(start, start + n_frames):
                for sub, root in (("cube_feat", self.feat_root), ("motion", self.motion_root)):
                    paths[sub].append(os.path.join(root, vid, sub, f"{f:06}.npy"))
        for sub, kind in (("cube_feat", "CAM"), ("motion", "flow")):
            for p in paths[sub]:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"missing {kind} frame {p}")
        if n_threads > 1:
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                cams, flows = (list(pool.map(np.load, paths[sub]))
                               for sub in ("cube_feat", "motion"))
        else:
            cams, flows = ([np.load(p) for p in paths[sub]] for sub in ("cube_feat", "motion"))
        cams = np.stack(cams).reshape(len(runs), n_frames, *cams[0].shape)
        # reference layout [6, C, h, w] -> NHWC; the artifact dtype is kept
        seq = np.ascontiguousarray(cams.transpose(0, 1, 2, 4, 5, 3))
        return seq, np.stack(flows).reshape(len(runs), n_frames, *flows[0].shape)

    def get_batch(self, idxs, n_threads: int = 0):
        """(seq [B,T,6,h,w,C], flows [B,T,H,W,2]) for the given windows."""
        return self.read_runs([self.windows[int(i)] for i in idxs], self.seq_len, n_threads)


class SegmentWindowDataset:
    """Groups of ``group`` consecutive windows read as ONE frame run
    (config ``segment_windows``; ``cp360_tpu/data/dataset.py:151``).

    Segment (vid, s) covers windows s .. s+group-1, i.e. frames s ..
    s+F-1 with F = group + seq_len - 1, so each frame is read and shipped
    once instead of up to seq_len times; the train step rebuilds the
    stride-1 windows on the device (train/loop.py::expand_segments) and
    the update equals the one on the windows fed directly.  A segment
    spans consecutive start indices of the base dataset only (a gap in the
    artifact numbering ends the run), and a run's tail of fewer than
    ``group`` windows is dropped, so every batch has one shape.
    """

    def __init__(self, base: WindowDataset, group: int):
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        self.base = base
        self.group = group
        self.seq_len = base.seq_len
        self.segments: List[Tuple[str, int]] = []  # (vid, first start index)
        run: List[int] = []
        prev_vid = None
        for vid, start in base.windows + [(None, None)]:  # sorted per video, ascending
            if vid != prev_vid or not run or start != run[-1] + 1:
                self.segments.extend((prev_vid, run[i])
                                     for i in range(0, len(run) - group + 1, group))
                run, prev_vid = [], vid
            run.append(start)

    def __len__(self) -> int:
        return len(self.segments)

    @property
    def n_windows(self) -> int:
        return len(self.segments) * self.group

    def get_batch(self, idxs, n_threads: int = 0):
        """Segments -> (seq [S, F, 6, h, w, C], flows [S, F, H, W, 2]),
        F = group + seq_len - 1."""
        return self.base.read_runs([self.segments[int(i)] for i in idxs],
                                   self.group + self.seq_len - 1, n_threads)


class PrefetchLoader:
    """Shuffled, batched, background-prefetching iterator over a dataset:
    one worker thread reads the next ``prefetch`` batches (each on
    ``num_threads`` reader threads) while the device runs the current one
    (the reference's DataLoader(num_workers=4),
    temporal_model/train_temporal.py:232-233).

    ``transfer_codec="int8"`` yields the CAM windows as
    :class:`~cp360_tpu_torch.ops.quantize.Quantized` (int8 + f32 scales,
    dequantized on the device by the train step) and the flows as f16.
    Flows never go int8: the motion mask compares |flow| with the absolute
    ``mm_th`` (0.15 px), and int8's step is a window's own peak / 127 (a
    20 px peak gives 0.157 px), which would zero the static mask; f16
    keeps the error near 0.01 px and still halves the flows' bytes.  The
    codec runs on the worker thread, beside the device's work.

    ``rows`` (a slice of the global batch) reads only those rows of every
    batch: every rank keeps the same seeded order, so the ranks' rows make
    up exactly the global batch, and the int8 scales are per sample, so a
    rank's rows quantize as they would in the whole batch.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 2, transfer_codec: str = "none",
                 rows: Optional[slice] = None):
        if transfer_codec not in ("none", "int8"):
            raise ValueError(f"transfer_codec={transfer_codec!r} is not one of 'none', 'int8'")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.transfer_codec = transfer_codec
        self.rows = rows

    def __len__(self) -> int:
        return len(self.ds) // self.batch_size  # a short last batch is dropped

    def load_batch(self, idxs):
        """One batch as the worker ships it (after the codec)."""
        seq, flows = self.ds.get_batch(idxs, n_threads=self.num_threads)
        if self.transfer_codec == "int8":
            from cp360_tpu_torch.ops.quantize import Quantized, quantize_cam_np

            seq = Quantized(*quantize_cam_np(seq))
            flows = flows.astype(np.float16)
        return seq, flows

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
        if self.rows is not None:
            batches = [b[self.rows] for b in batches]

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
                    if stop.is_set() or not put(self.load_batch(idxs)):
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
