"""PyTorch port, the training batches' page-locked path on the card: the
loader's reads into pinned memory (``data/dataset.py::PrefetchLoader``) and
their copies without blocking (``train/loop.py::batch_to_device``,
``PinnedUploads``).

Every test carries the ``cuda`` marker and skips without a card; this file
imports neither JAX nor the JAX package, so on a machine with the card:

    python -m pytest tests/test_torch_pinned_upload.py --noconftest -q

The benchmark checks only its set-up's first steps, so a batch that a reused
block corrupted later would pass there.  Here four epochs of the trainer's
batches (f16 CAM cubes [6, C, 7, 7] in NHWC, f32 flows [H, 2H, 2], windows
of 5, shuffled) stream through the loader and ``batch_to_device`` while the
device lags behind the host, on one of two streams:

- the caller's, after the uploads: the step reads late, so a copy stream
  that reused a device block freed on the host could overwrite a batch
  still to be read;
- the copy stream, before the uploads: the copies run late, so the loader
  could refill a host block still to be copied, and a caller that did not
  wait for its copy would read the block before it.

Each uploaded batch, cloned on the caller's stream, is compared bit for bit
with its files read by numpy and transposed to NHWC; once with each yielded
batch dropped, once with every one held; whole, and as a rank's rows
(``parallel/mesh.py::shard_batch``), a view that starts inside its block,
where the caching host allocator finds no block to record the copy's event
on.  Every byte goes the pinned way, the uploads in flight stay within the
bound, and the pinned pool stays bounded while it is reused.
"""

import numpy as np
import pytest
import torch

from cp360_tpu_torch import native
from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset
from cp360_tpu_torch.train import loop

C, FH, T, B = 64, 96, 5, 4  # CAM channels, flow height, window, batch
VIDS = ["v0", "v1", "v2"]
FRAMES = 14  # 9 windows a video: 6 batches an epoch
EPOCHS = 4
SEED = 2147483911
LAG_CYCLES = 100_000_000  # ~50 ms of the device's clock a batch, longer than the host's turn


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory and the copy stream live on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("arts")
    rng = np.random.RandomState(7)
    for vid in VIDS:
        (root / vid / "cube_feat").mkdir(parents=True)
        (root / vid / "motion").mkdir(parents=True)
        for i in range(FRAMES):
            np.save(root / vid / "cube_feat" / f"{i:06}.npy",
                    rng.gamma(0.5, 2.0, (6, C, 7, 7)).astype(np.float16))
            np.save(root / vid / "motion" / f"{i:06}.npy",
                    rng.randn(FH, 2 * FH, 2).astype(np.float32))
    return str(root)


def _from_files(root, windows):
    """A batch read by numpy from its files: (seq NHWC, flows)."""
    def read(sub, shape, dtype):
        paths = [f"{root}/{vid}/{sub}/{s + t:06}.npy" for vid, s in windows for t in range(T)]
        return native.load_npy_batch_plain(paths, shape, dtype).reshape(len(windows), T, *shape)

    cams = read("cube_feat", (6, C, 7, 7), np.float16)
    return (np.ascontiguousarray(cams.transpose(0, 1, 2, 4, 5, 3)),
            read("motion", (FH, 2 * FH, 2), np.float32))


def _windows(ds, epoch):
    """The windows of each batch of ``epoch``, as the loader orders them."""
    order = np.arange(len(ds))
    np.random.RandomState(SEED + epoch).shuffle(order)
    return [[ds.windows[i] for i in order[b * B:(b + 1) * B]] for b in range(len(ds) // B)]


def _pool_bytes():
    """Bytes the caching host allocator holds (active and cached); 0 before
    its first block, and where this PyTorch does not report them."""
    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    return stats.get("allocated_bytes.current", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [slice(None), slice(1, None)], ids=["whole", "rows"])
@pytest.mark.parametrize("hold", [False, True], ids=["drop", "hold"])
@pytest.mark.parametrize("lag", ["caller", "copy"])
def test_streamed_batches_equal_their_files(card, artifacts, monkeypatch, lag, hold, rows):
    counts = {}
    monkeypatch.setattr(loop, "count", lambda name, n: counts.__setitem__(
        name, counts.get(name, 0) + n))
    ds = WindowDataset(artifacts, None, VIDS, T)
    loader = PrefetchLoader(ds, batch_size=B, seed=SEED, num_threads=2)
    ups = loop.pinned_uploads(card)
    first = _from_files(artifacts, _windows(ds, 0)[0])
    batch_bytes, sent_bytes = sum(a.nbytes for a in first), sum(a[rows].nbytes for a in first)
    pool0, peak = _pool_bytes(), 0
    got, held = [], []
    for epoch in range(EPOCHS):
        for seq, flows in loader:
            assert seq.dtype == np.float16 and flows.dtype == np.float32
            assert torch.from_numpy(seq).is_pinned() and torch.from_numpy(flows).is_pinned()
            if hold:
                held.append((seq, flows))
            if lag == "copy":
                with torch.cuda.stream(ups.stream):
                    torch.cuda._sleep(LAG_CYCLES)
            d_seq = loop.batch_to_device(seq[rows], card)
            d_flows = loop.batch_to_device(flows[rows], card)
            assert len(ups.held) <= loop.RUN_AHEAD + 1
            if lag == "caller":
                torch.cuda._sleep(LAG_CYCLES)
            got.append((d_seq.clone(), d_flows.clone()))
            del seq, flows, d_seq, d_flows
            peak = max(peak, _pool_bytes() - pool0)
    torch.cuda.synchronize(card)
    want = [w[rows] for epoch in range(EPOCHS) for w in _windows(ds, epoch)]
    assert len(got) == len(want) == EPOCHS * 6
    for i, ((d_seq, d_flows), windows) in enumerate(zip(got, want)):
        seq, flows = _from_files(artifacts, windows)
        assert d_seq.cpu().numpy().tobytes() == seq.tobytes(), f"batch {i}: CAMs"
        assert d_flows.cpu().numpy().tobytes() == flows.tobytes(), f"batch {i}: flows"
    assert counts["h2d.pinned_bytes"] == counts["h2d.bytes"] == len(got) * sent_bytes
    if not hold:
        # a batch holds three blocks (flows, the CAMs as read, NHWC), each
        # rounded up to a power of two: 1.7 batches' bytes here.  A few
        # batches at once stay under 16; a block for each of the 24 batches
        # streamed would pass 40
        assert peak <= 16 * batch_bytes, (peak, batch_bytes)
        print(f"pinned pool grew by {peak} bytes, {peak / batch_bytes:.2f} batches")


@pytest.mark.cuda
def test_pageable_batches_take_the_pageable_copy(card, monkeypatch):
    counts = {}
    monkeypatch.setattr(loop, "count", lambda name, n: counts.__setitem__(
        name, counts.get(name, 0) + n))
    x = np.random.RandomState(0).randn(4, 5, 8, 16, 2).astype(np.float32)
    y = loop.batch_to_device(x, card)
    assert y.device == card and np.array_equal(y.cpu().numpy(), x)
    assert counts == {"h2d.bytes": x.nbytes, "h2d.pinned_bytes": 0}
