"""Dataset over stage-1 artifacts + a threaded prefetch loader.

The port's copy of ``cp360_tpu/data/dataset.py`` (reference Sal360Dataset,
data/dataset.py:13-83): windows of ``seq_len`` consecutive CAM cubes and
optical flows from ``<root>/<vid>/cube_feat/NNNNNN.npy`` ([6, C, h, w]) and
``<root>/<vid>/motion/NNNNNN.npy`` ([H, W, 2]), starting at frames with
index < max_index - seq_len + 1 (data/dataset.py:39).  Missing frames raise;
batches are contiguous numpy arrays with the cubes transposed to NHWC and
the artifacts' dtype kept (the train step widens to f32).

Files are read by the batch ``.npy`` loader (``native/``, C++ threads, no
GIL) on ``num_threads`` threads.  :class:`SegmentWindowDataset` groups
consecutive windows into one frame run (config ``segment_windows``), and
the loader's ``transfer_codec: int8`` ships the CAM windows as int8 plus
f32 scales and the flows as f16.  ``rows`` reads only one rank's span of
every global batch (``parallel/mesh.py::local_rows_slice``).  With
``require_motion=False`` a window needs only its CAM files, and its flows
are empty planes [..., 0, 0, 2] f32.

On a machine with a card, :class:`PrefetchLoader` reads each batch into
page-locked host memory (:func:`pinned_empty`) that PyTorch's caching host
allocator hands back batch after batch, so a read neither allocates nor
first-touches its pages, and ``train/loop.py::batch_to_device`` copies the
batch to the card without blocking.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cp360_tpu_torch import native
from cp360_tpu_torch.utils.profiling import annotate


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialised numpy array in page-locked host memory: a view of a
    ``torch.empty(..., pin_memory=True)`` tensor, which keeps it alive.  The
    tensor's block comes from PyTorch's caching host allocator and goes back
    to it when the last view is dropped, ready for the next batch."""
    like = torch.from_numpy(np.empty(0, dtype)).dtype
    return torch.empty(tuple(shape), dtype=like, pin_memory=True).numpy()


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
                 video_ids: Sequence[str], seq_len: int, require_motion: bool = True):
        self.feat_root = feat_root
        self.motion_root = motion_root if motion_root is not None else feat_root
        self.seq_len = seq_len
        self.require_motion = require_motion
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

    def read_runs(self, runs: Sequence[Tuple[str, int]], n_frames: int, n_threads: int = 0,
                  *, empty=np.empty):
        """(seq [R, n_frames, 6, h, w, C], flows [R, n_frames, H, W, 2]) for
        runs of ``n_frames`` consecutive frames starting at each (vid, first
        frame index), read by the batch loader on ``n_threads`` threads (0:
        one per hardware thread), each kind in the shape and dtype of its
        first file.  A missing file raises before any is read.  Without
        ``require_motion`` no flow file is read, and the flows are empty
        planes [R, n_frames, 0, 0, 2] f32.

        ``empty(shape, dtype)`` gives each array the read fills (numpy's
        by default; :func:`pinned_empty` for page-locked memory): the flows,
        the CAMs as the files hold them, and the NHWC batch that torch's
        threaded copy permutes them into."""
        kinds = (("cube_feat", self.feat_root, "CAM"),)
        if self.require_motion:
            kinds += (("motion", self.motion_root, "flow"),)
        paths = {sub: [os.path.join(root, vid, sub, f"{f:06}.npy")
                       for vid, start in runs for f in range(start, start + n_frames)]
                 for sub, root, _ in kinds}
        for sub, _, kind in kinds:
            for p in paths[sub]:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"missing {kind} frame {p}")

        def read(sub):
            shape, dtype = native.npy_header(paths[sub][0])
            out = empty((len(paths[sub]), *shape), dtype)
            native.load_npy_batch(paths[sub], shape, dtype, n_threads, out=out)
            return out.reshape(len(runs), n_frames, *shape)

        cams = read("cube_feat")
        # reference layout [6, C, h, w] -> NHWC; the artifact dtype is kept
        nhwc = torch.from_numpy(cams).permute(0, 1, 2, 4, 5, 3)
        seq = empty(tuple(nhwc.shape), cams.dtype)
        torch.from_numpy(seq).copy_(nhwc)
        if not self.require_motion:
            return seq, np.zeros((len(runs), n_frames, 0, 0, 2), np.float32)
        return seq, read("motion")

    def get_batch(self, idxs, n_threads: int = 0, *, empty=np.empty):
        """(seq [B,T,6,h,w,C], flows [B,T,H,W,2]) for the given windows,
        each array from ``empty`` (:meth:`read_runs`)."""
        return self.read_runs([self.windows[int(i)] for i in idxs], self.seq_len, n_threads,
                              empty=empty)


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

    def get_batch(self, idxs, n_threads: int = 0, *, empty=np.empty):
        """Segments -> (seq [S, F, 6, h, w, C], flows [S, F, H, W, 2]),
        F = group + seq_len - 1, each array from ``empty``."""
        return self.base.read_runs([self.segments[int(i)] for i in idxs],
                                   self.group + self.seq_len - 1, n_threads, empty=empty)


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
    codec runs on the worker thread, beside the device's work; it leaves
    the empty flows of ``require_motion=False`` as they are.

    On a machine with a card (``torch.cuda.is_available()``) the worker
    reads every batch into page-locked memory (:func:`pinned_empty`): the
    batches are the same numpy arrays, views of pinned tensors, which
    ``train/loop.py::batch_to_device`` copies without blocking.  Without a
    card each batch is read into fresh numpy arrays.  A dataset's
    ``get_batch(idxs, n_threads, empty=...)`` takes the allocator.

    ``drop_last`` drops a short last batch (``len`` counts whole batches
    only); without it the last batch holds the remaining windows.

    ``rows`` (a slice of the global batch) reads only those rows of every
    batch: every rank keeps the same seeded order, so the ranks' rows make
    up exactly the global batch, and the int8 scales are per sample, so a
    rank's rows quantize as they would in the whole batch.  It needs
    ``drop_last``.

    Iterating the loader itself gives epoch 0, then 1, ... of
    :meth:`iter_epoch`, counted from the loader's creation.

    Spans (``utils/profiling.py::annotate``): ``loader.read`` for each
    batch the worker reads, ``loader.wait`` for each wait of the consumer
    on the queue.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 2, drop_last: bool = True,
                 transfer_codec: str = "none", rows: Optional[slice] = None):
        if transfer_codec not in ("none", "int8"):
            raise ValueError(f"transfer_codec={transfer_codec!r} is not one of 'none', 'int8'")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.transfer_codec = transfer_codec
        self.rows = rows
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        it = self.iter_epoch(self._epoch)
        self._epoch += 1
        return it

    def load_batch(self, idxs):
        """One batch as the worker ships it (after the codec)."""
        empty = pinned_empty if torch.cuda.is_available() else np.empty
        seq, flows = self.ds.get_batch(idxs, n_threads=self.num_threads, empty=empty)
        if self.transfer_codec == "int8":
            from cp360_tpu_torch.ops.quantize import Quantized, quantize_cam_np

            seq = Quantized(*quantize_cam_np(seq))
            if flows.size:  # the empty planes of require_motion=False stay f32
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
            if not self.drop_last:
                raise ValueError(
                    "per-host row slicing (rows=...) requires drop_last=True "
                    "— a short final batch would break the span contract")
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
                    if stop.is_set():
                        return
                    with annotate("loader.read"):
                        batch = self.load_batch(idxs)
                    if not put(batch):
                        return
                put(None)
            except Exception as e:  # surfaced to the consumer, raised there
                put(e)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                with annotate("loader.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=5)
