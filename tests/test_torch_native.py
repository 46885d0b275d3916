"""PyTorch port, the batch ``.npy`` loader (``cp360_tpu_torch/native/``).

The nine cases of tests/test_native.py run against the port's loader, then:
the port's loader is bit-equal to the JAX package's ``load_npy_batch`` on
the same files; ``WindowDataset.get_batch`` and
``SegmentWindowDataset.get_batch`` are bit-equal to the JAX package's on
seeded f16 and f32 artifacts; a build that fails raises with the
compiler's output and reads nothing with numpy.  Every comparison is bit
for bit: the loader copies the files' bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cp360_tpu import native as jax_native
from cp360_tpu.data import dataset as jax_dataset
from cp360_tpu_torch import native
from cp360_tpu_torch.data import dataset
from cp360_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (6, 8, 7, 7)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape, b.dtype, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def npy_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("npys")
    rng = np.random.RandomState(0)
    arrays = [rng.rand(*SHAPE).astype(np.float32) for _ in range(12)]
    paths = []
    for i, a in enumerate(arrays):
        p = str(d / f"{i:06}.npy")
        np.save(p, a)
        paths.append(p)
    return paths, arrays


def test_load_batch_matches_numpy(npy_dir):
    paths, arrays = npy_dir
    out = native.load_npy_batch(paths, SHAPE, np.float32)
    _bits_equal(out, np.stack(arrays))
    _bits_equal(out, native.load_npy_batch_plain(paths, SHAPE, np.float32))
    assert native.npy_header(paths[0]) == (SHAPE, np.dtype(np.float32))


@pytest.mark.parametrize("n_threads", [1, 3, 0, 64])
def test_load_batch_threads(npy_dir, n_threads):
    paths, arrays = npy_dir
    out = native.load_npy_batch(paths, SHAPE, np.float32, n_threads=n_threads)
    _bits_equal(out, np.stack(arrays))


def test_load_batch_into_preallocated(npy_dir):
    paths, arrays = npy_dir
    buf = np.empty((len(paths), *SHAPE), np.float32)
    out = native.load_npy_batch(paths, SHAPE, np.float32, out=buf)
    assert out is buf
    _bits_equal(buf, np.stack(arrays))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.load_npy_batch(paths, SHAPE, np.float32, out=buf[:, ::-1])


def test_missing_file_raises(npy_dir, tmp_path):
    paths, _ = npy_dir
    bad = paths[:2] + [str(tmp_path / "nope.npy")]
    with pytest.raises(IOError, match="nope.npy"):
        native.load_npy_batch(bad, SHAPE, np.float32)


def test_wrong_shape_raises(npy_dir, tmp_path):
    paths, _ = npy_dir
    small = str(tmp_path / "small.npy")
    np.save(small, np.zeros((2, 2), np.float32))
    with pytest.raises(IOError, match="small.npy: payload 16 bytes"):
        native.load_npy_batch(paths[:1] + [small], SHAPE, np.float32)


def test_not_npy_raises(tmp_path):
    junk = str(tmp_path / "junk.npy")
    with open(junk, "wb") as f:
        f.write(b"this is not numpy at all")
    with pytest.raises(IOError, match="magic"):
        native.load_npy_batch([junk], (2,), np.float32)


def test_fortran_order_is_refused(tmp_path):
    """Its bytes are not the C-order array np.load returns: refused rather
    than read transposed."""
    p = str(tmp_path / "f.npy")
    np.save(p, np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4)))
    with pytest.raises(IOError, match="Fortran-order"):
        native.load_npy_batch([p], (3, 4), np.float32)


def test_f16_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    a = rng.rand(6, 1000, 7, 7).astype(np.float16)
    p = str(tmp_path / "f16.npy")
    np.save(p, a)
    out = native.load_npy_batch([p], a.shape, np.float16)
    _bits_equal(out[0], a)


def test_equals_the_jax_loader(npy_dir):
    paths, _ = npy_dir
    for n_threads in (0, 3):
        _bits_equal(native.load_npy_batch(paths, SHAPE, np.float32, n_threads),
                    jax_native.load_npy_batch(paths, SHAPE, np.float32, n_threads))


def _artifacts(root, dtype, n_frames=12, vids=("v1", "v2")):
    rng = np.random.RandomState(0)
    for vid in vids:
        (root / vid / "cube_feat").mkdir(parents=True)
        (root / vid / "motion").mkdir(parents=True)
        for t in range(2, 2 + n_frames):
            np.save(root / vid / "cube_feat" / f"{t:06}.npy",
                    rng.gamma(0.5, 2.0, (6, 4, 7, 7)).astype(dtype))
            np.save(root / vid / "motion" / f"{t:06}.npy",
                    rng.randn(8, 16, 2).astype(dtype))
    return str(root), list(vids)


def test_dataset_get_batch_matches_getitem(tmp_path):
    root, vids = _artifacts(tmp_path / "arts", np.float32, vids=("v1",))
    ds = dataset.WindowDataset(root, None, vids, seq_len=5)
    idxs = [0, 2, 3]
    seq_b, flow_b = ds.get_batch(idxs)
    for k, i in enumerate(idxs):
        seq_i, flow_i, _, _ = ds[i]
        _bits_equal(seq_b[k], seq_i)
        _bits_equal(flow_b[k], flow_i)


@pytest.mark.parametrize("kind", ["windows", "segments"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_dataset_batches_equal_jax(tmp_path, monkeypatch, dtype, kind):
    root, vids = _artifacts(tmp_path / "arts", dtype)
    mine = dataset.WindowDataset(root, None, vids, seq_len=5)
    theirs = jax_dataset.WindowDataset(root, None, vids, seq_len=5)
    if kind == "segments":
        mine = dataset.SegmentWindowDataset(mine, 2)
        theirs = jax_dataset.SegmentWindowDataset(theirs, 2)
    assert len(mine) == len(theirs) > 2
    idxs = [len(mine) - 1, 0, 2]
    for n_threads in (1, 4):
        got, want = mine.get_batch(idxs, n_threads), theirs.get_batch(idxs, n_threads)
        for a, b in zip(got, want):
            assert a.dtype == dtype
            _bits_equal(a, b)
    # PrefetchLoader's batch through the loader is the plain reader's
    loader = dataset.PrefetchLoader(mine, 3, shuffle=False)
    loaded = loader.load_batch(idxs)
    with monkeypatch.context() as m:
        m.setattr(native, "load_npy_batch", native.load_npy_batch_plain)
        by_numpy = loader.load_batch(idxs)
    for a, b in zip(loaded, by_numpy):
        _bits_equal(a, b)


class DirtyEmpty:
    """An allocator like the caching host allocator's reuse: each array
    comes back full of 0xff bytes (NaN in a float), as a block another
    batch wrote would, so a byte the read leaves unwritten shows.  It keeps
    what it gave, to tell which arrays a batch holds came from it."""

    def __init__(self):
        self.given = []

    def __call__(self, shape, dtype):
        a = np.empty(shape, dtype)
        a.view(np.uint8).fill(0xFF)
        self.given.append(a)
        return a

    def gave(self, arr) -> bool:
        return any(np.shares_memory(arr, a) for a in self.given)


@pytest.mark.parametrize("kind", ["windows", "segments"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_dataset_batches_into_given_memory_equal_jax(tmp_path, dtype, kind):
    """get_batch with an allocator (``empty=``, as the loader passes
    pinned memory on a card) fills arrays from it that are bit for bit the
    JAX package's batch: same dtypes, shapes, C order and windows."""
    root, vids = _artifacts(tmp_path / "arts", dtype)
    mine = dataset.WindowDataset(root, None, vids, seq_len=5)
    theirs = jax_dataset.WindowDataset(root, None, vids, seq_len=5)
    if kind == "segments":
        mine = dataset.SegmentWindowDataset(mine, 2)
        theirs = jax_dataset.SegmentWindowDataset(theirs, 2)
    idxs = [len(mine) - 1, 0, 2]
    for n_threads in (1, 4):
        empty = DirtyEmpty()
        got = mine.get_batch(idxs, n_threads, empty=empty)
        for a, b in zip(got, theirs.get_batch(idxs, n_threads)):
            _bits_equal(a, b)
            assert a.flags.c_contiguous and empty.gave(a)


@pytest.mark.parametrize("rows", [None, slice(1, 3)], ids=["whole", "rows"])
def test_loader_on_a_card_reads_into_pinned_memory(tmp_path, monkeypatch, rows):
    """Where torch sees a card, the loader's worker takes every array from
    ``pinned_empty`` (a stand-in here) and yields batches bit for bit equal
    to the fresh arrays it reads without one, a rank's rows included."""
    root, vids = _artifacts(tmp_path / "arts", np.float16)
    ds = dataset.WindowDataset(root, None, vids, seq_len=5)
    kw = dict(batch_size=4, seed=5, num_threads=2, rows=rows)
    without = [tuple(b) for b in dataset.PrefetchLoader(ds, **kw).iter_epoch(1)]
    empty = DirtyEmpty()
    monkeypatch.setattr(dataset.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dataset, "pinned_empty", empty)
    got = [tuple(b) for b in dataset.PrefetchLoader(ds, **kw).iter_epoch(1)]
    assert len(got) == len(without) == 3
    for batch, want in zip(got, without):
        for a, b in zip(batch, want):
            _bits_equal(a, b)
            assert empty.gave(a) and not empty.gave(b)


def test_loader_without_a_card_reads_into_fresh_arrays(tmp_path, monkeypatch):
    """No card: the loader never asks for pinned memory, and yields the JAX
    package's batches."""
    root, vids = _artifacts(tmp_path / "arts", np.float32)
    kw = dict(batch_size=3, seed=1)
    monkeypatch.setattr(dataset.torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dataset, "pinned_empty", None)  # any call would fail
    got = list(dataset.PrefetchLoader(dataset.WindowDataset(root, None, vids, 5), **kw))
    want = list(jax_dataset.PrefetchLoader(jax_dataset.WindowDataset(root, None, vids, 5), **kw))
    assert len(got) == len(want) > 2
    for batch, jbatch in zip(got, want):
        for a, b in zip(batch, jbatch):
            _bits_equal(a, b)


def test_missing_frame_raises_before_any_read(tmp_path, monkeypatch):
    root, vids = _artifacts(tmp_path / "arts", np.float32, vids=("v1",))
    os.remove(os.path.join(root, "v1", "motion", "000004.npy"))
    ds = dataset.WindowDataset(root, None, vids, seq_len=5)
    monkeypatch.setattr(native, "load_npy_batch", None)  # any read would fail otherwise
    with pytest.raises(FileNotFoundError, match="missing flow frame .*000004.npy"):
        ds.get_batch([0])


def _isolated_build(monkeypatch, tmp_path):
    """Builds go to ``tmp_path`` with no cached library: the shared build
    directory and this process's loaded libraries stay as they are."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})


def test_build_failure_raises_with_the_compiler_output(npy_dir, tmp_path, monkeypatch):
    paths, _ = npy_dir
    _isolated_build(monkeypatch, tmp_path)
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'fake-g++: error: no working toolchain' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "gxx_path", lambda: str(fake))

    def no_numpy(*a, **k):
        raise AssertionError("the loader fell back to numpy")

    monkeypatch.setattr(np, "load", no_numpy)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for npy_loader.cpp(.|\\n)*"
                                           "fake-g\\+\\+: error: no working toolchain"):
        native.load_npy_batch(paths, SHAPE, np.float32)
    assert not native.available()
    assert not list((tmp_path / "build").glob("*.so")) and not list(
        (tmp_path / "build").glob("*.tmp"))


def test_corrupt_cached_library_heals(npy_dir, tmp_path, monkeypatch):
    """A cached library that does not load is built again once; the
    corrupt file lives in an isolated build directory, so no library that
    a process has mapped is touched.  In a subprocess, so that the failed
    load cannot poison this process."""
    paths, arrays = npy_dir
    script = (
        "import sys\n"
        "from pathlib import Path\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from cp360_tpu_torch import native\n"
        "from cp360_tpu_torch.ops import _build\n"
        f"_build.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "so = _build.library_path(native.NAME)\n"
        "so.write_bytes(b'garbage')\n"
        f"a = native.load_npy_batch([{paths[0]!r}], {SHAPE!r}, np.float32)\n"
        f"assert a.tobytes() == np.load({paths[0]!r}).tobytes()\n"
        "print('healed', a.shape, so.stat().st_size > 1000)\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "healed (1, 6, 8, 7, 7) True" in out.stdout
    assert native.available()
