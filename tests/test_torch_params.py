"""PyTorch port, the public parameters, methods and config fields that
``tests/test_torch_coverage.py`` holds, against the JAX package on the CPU:
``WindowDataset(require_motion=False)``, ``PrefetchLoader``'s ``drop_last``
and iteration, ``NpzCheckpointer.wait``, ``extract_video``'s
``batch_frames``, ``resume`` and ``log_fn``, ``Config.upload_depth``,
``infer_video``'s ``prefetch_depth`` and the single-pair flow solvers'
parameters.

Sizes are cut for the CPU (CAM channels 16 on 7x7 faces, ConvLSTM 8/8,
extraction on 32x64 frames with 64-pixel faces and a 16-class CAM); the
code paths are the full-width ones.  Inputs come from seeded numpy.
Tolerances: datasets and loader batches bit for bit against the JAX
package; window predictions within 1e-5 of the JAX package's (as
``tests/test_torch_video.py`` holds ``infer_video``) and bit for bit
between prefetch depths; artifacts bit for bit between upload depths and
within 1e-6 of their largest value between batch sizes (the CPU's
convolutions are not batch-invariant), and CAMs within 1e-4 of their largest value
against the JAX package's ``extract_video``; single-pair flows within
1e-3 px of the JAX package's (``tests/test_torch_flow.py``'s bound) and
bit for bit against the port's batch solver.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.data import dataset as jax_dataset
from cp360_tpu.flow import optical_flow as jflow
from cp360_tpu.flow import variational as jvar
from cp360_tpu.ops.quantize import Quantized as JaxQuantized
from cp360_tpu.pipelines import extract as jax_extract
from cp360_tpu.pipelines import temporal as jax_temporal
from cp360_tpu.train import checkpoint as jax_checkpoint
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.data.dataset import PrefetchLoader, SegmentWindowDataset, WindowDataset
from cp360_tpu_torch.flow import optical_flow as flow
from cp360_tpu_torch.flow import variational as var
from cp360_tpu_torch.ops.quantize import Quantized
from cp360_tpu_torch.pipelines import extract, temporal
from cp360_tpu_torch.train.checkpoint import NpzCheckpointer

torch.set_num_threads(2)

C = 16
T = 5
VIDS = ["vidA", "vidB"]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- the dataset without motion ------------------------------------------------


@pytest.fixture(scope="module")
def cams_only(tmp_path_factory):
    """Two videos of f32 CAM cubes, 000002..000012, and no motion dir."""
    root = tmp_path_factory.mktemp("cams_only")
    rng = np.random.RandomState(11)
    for vid, n in zip(VIDS, (11, 8)):
        (root / vid / "cube_feat").mkdir(parents=True)
        for t in range(2, 2 + n):
            np.save(root / vid / "cube_feat" / f"{t:06}.npy",
                    rng.gamma(0.5, 2.0, (6, C, 7, 7)).astype(np.float32))
    return str(root)


def test_require_motion_false_windows_and_items_equal_jax(cams_only):
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    assert ds.windows == jds.windows and len(ds) == len(jds) == 6 + 3
    for i in (0, 4, len(ds) - 1):
        seq, flows, vid, start = ds[i]
        jseq, jflows, jvid, jstart = jds[i]
        assert (vid, start) == (jvid, jstart)
        _equal(seq, jseq)
        _equal(flows, jflows)
        assert flows.shape == (T, 0, 0, 2) and flows.dtype == np.float32
    # the default still needs the flows, in both packages
    with pytest.raises(FileNotFoundError, match="missing flow frame"):
        WindowDataset(cams_only, None, VIDS, T)[0]
    with pytest.raises(FileNotFoundError, match="missing flow frame"):
        jax_dataset.WindowDataset(cams_only, None, VIDS, T)[0]


@pytest.mark.parametrize("group", [0, 2])
def test_require_motion_false_batches_equal_jax(cams_only, group):
    """get_batch of the window dataset and (group 2) of the segment dataset
    over it: the CAMs bit for bit, the flows empty [B, F, 0, 0, 2] f32."""
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    if group:
        ds, jds = SegmentWindowDataset(ds, group), jax_dataset.SegmentWindowDataset(jds, group)
        assert ds.segments == jds.segments
    idxs = np.arange(len(ds))[::-1]
    got, want = ds.get_batch(idxs, n_threads=2), jds.get_batch(idxs)
    for a, b in zip(got, want):
        _equal(a, b)
    assert got[1].shape == (len(ds), T + max(group, 1) - 1, 0, 0, 2)


@pytest.mark.parametrize("group", [0, 2])
def test_require_motion_false_batches_into_given_memory_equal_jax(cams_only, group):
    """get_batch with an allocator (``empty=``, the loader's pinned memory
    on a card): the CAMs bit for bit in its arrays, the flows still empty
    [B, F, 0, 0, 2] f32 planes of their own."""
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    if group:
        ds, jds = SegmentWindowDataset(ds, group), jax_dataset.SegmentWindowDataset(jds, group)
    given = []

    def empty(shape, dtype):
        given.append(np.full(shape, np.nan, dtype))
        return given[-1]

    idxs = np.arange(len(ds))[::-1]
    got, want = ds.get_batch(idxs, n_threads=2, empty=empty), jds.get_batch(idxs)
    for a, b in zip(got, want):
        _equal(a, b)
    assert any(np.shares_memory(got[0], a) for a in given)
    assert got[1].shape == (len(ds), T + max(group, 1) - 1, 0, 0, 2)


def test_require_motion_false_int8_codec_leaves_the_flows_alone(cams_only):
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    kw = dict(batch_size=2, seed=3, transfer_codec="int8")
    got = list(PrefetchLoader(ds, num_threads=2, **kw).iter_epoch(0))
    want = list(jax_dataset.PrefetchLoader(jds, **kw).iter_epoch(0))
    assert len(got) == len(want) == 4
    for (seq, flows), (jseq, jflows) in zip(got, want):
        assert isinstance(seq, Quantized) and isinstance(jseq, JaxQuantized)
        _equal(seq.q, jseq.q)
        _equal(seq.scales, jseq.scales)
        _equal(flows, jflows)
        assert flows.dtype == np.float32 and flows.size == 0


# ---- the loader's drop_last and iteration ---------------------------------------


def _batches(it):
    return [(np.asarray(seq), np.asarray(flows)) for seq, flows in it]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (seq, flows), (jseq, jflows) in zip(got, want):
        _equal(seq, jseq)
        _equal(flows, jflows)


@pytest.mark.parametrize("drop_last", [True, False])
def test_drop_last_len_and_batches_equal_jax(cams_only, drop_last):
    """9 windows in batches of 4: 2 batches, or 3 with a last one of 1."""
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    kw = dict(batch_size=4, shuffle=True, seed=2, drop_last=drop_last)
    loader, jloader = PrefetchLoader(ds, num_threads=2, **kw), jax_dataset.PrefetchLoader(jds, **kw)
    assert len(loader) == len(jloader) == (2 if drop_last else 3)
    got, want = _batches(loader.iter_epoch(1)), _batches(jloader.iter_epoch(1))
    _same_batches(got, want)
    assert [len(s) for s, _ in got] == [4, 4] + ([] if drop_last else [1])
    tail = _batches(loader.iter_epoch(1, skip_batches=len(loader) - 1))
    _same_batches(tail, want[-1:])


def test_rows_need_drop_last_as_in_jax(cams_only):
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    kw = dict(batch_size=4, drop_last=False, rows=slice(0, 2))
    errors = []
    for loader in (PrefetchLoader(ds, **kw), jax_dataset.PrefetchLoader(jds, **kw)):
        with pytest.raises(ValueError) as e:
            next(iter(loader.iter_epoch(0)))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "requires drop_last=True" in errors[0]
    rows = PrefetchLoader(ds, batch_size=4, shuffle=False, rows=slice(1, 3))
    assert [s.shape[0] for s, _ in rows.iter_epoch(0)] == [2, 2]


@pytest.mark.parametrize("shuffle", [True, False])
def test_iterating_the_loader_counts_epochs_as_jax(cams_only, shuffle):
    """Two `for` loops over one loader: epoch 0 then epoch 1, in the JAX
    loader's order, each equal to iter_epoch of its number."""
    ds = WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    jds = jax_dataset.WindowDataset(cams_only, None, VIDS, T, require_motion=False)
    kw = dict(batch_size=3, shuffle=shuffle, seed=4)
    loader, jloader = PrefetchLoader(ds, num_threads=2, **kw), jax_dataset.PrefetchLoader(jds, **kw)
    for epoch in (0, 1):
        got = _batches(loader)
        _same_batches(got, _batches(jloader))
        _same_batches(got, _batches(loader.iter_epoch(epoch)))
    if shuffle:
        first, second = _batches(loader.iter_epoch(0)), _batches(loader.iter_epoch(1))
        assert any(not np.array_equal(a[0], b[0]) for a, b in zip(first, second))


# ---- the checkpointer -------------------------------------------------------------


def test_npz_checkpointer_wait_returns_none(tmp_path):
    ck = NpzCheckpointer(str(tmp_path))
    assert ck.wait() is None
    assert jax_checkpoint.NpzCheckpointer(str(tmp_path)).wait() is None
    assert not ck.has_state()


# ---- extraction: batch_frames, resume, log_fn and upload_depth -----------------------


ROWS, COLS, CD = 32, 64, 64


@pytest.fixture(scope="module")
def resnet_tree():
    return jax_params.init_resnet_params(8, "resnet50", num_classes=16)


@pytest.fixture(scope="module")
def model(resnet_tree):
    return jax_params.resnet_from_params(resnet_tree, compute_dtype=torch.float32)


def _cfg(**kw):
    base = dict(equi_h=COLS, equi_w=ROWS, cube_dim=CD, opt_flow=False,
                compute_dtype="float32", feat_dtype="float32", host_cube_remap=False)
    base.update(kw)
    return Config(**base)


def _frames(n, seed=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (ROWS, COLS, 3)).astype(np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """17 seeded noise frames as an mp4 (cv2)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("params_video") / "noise.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (COLS, ROWS))
    for f in _frames(17):
        vw.write(f)
    vw.release()
    return path


def _artifacts(out):
    feat = os.path.join(out, "cube_feat")
    return {n: np.load(os.path.join(feat, n)) for n in sorted(os.listdir(feat))}


def _same_artifacts(a, b):
    assert sorted(a) == sorted(b) and a
    for n in a:
        _equal(a[n], b[n])


def test_extract_video_batch_frames_and_log_fn_equal_jax(model, resnet_tree, video, tmp_path):
    """16 artifacts in batches of 8 (the default) and 16, alike within 1e-6
    of their largest value in f32 (the CPU's convolutions are not
    batch-invariant: the two lie a few f32 ulps apart); each within the CAM
    bound of the JAX package's extract_video at its default; each package's
    log_fn gets one summary line."""
    outs, lines = {}, {}
    for bf in (8, 16):
        lines[bf] = []
        kw = dict(batch_frames=bf) if bf != 8 else {}
        out = str(tmp_path / f"b{bf}")
        assert extract.extract_video(model, _cfg(), video, out, output_img=False,
                                     log_fn=lines[bf].append, **kw) == 16
        outs[bf] = _artifacts(out)
    assert sorted(outs[8]) == sorted(outs[16])
    for n, a in outs[8].items():
        assert a.dtype == outs[16][n].dtype == np.float32
        assert np.abs(a - outs[16][n]).max() <= 1e-6 * np.abs(a).max()
    jlines = []
    jout = str(tmp_path / "jax")
    jcfg = JaxConfig(equi_h=COLS, equi_w=ROWS, cube_dim=CD, opt_flow=False,
                     compute_dtype="float32", feat_dtype="float32", host_cube_remap=False)
    assert jax_extract.extract_video(_jax(resnet_tree), jcfg, video, jout, output_img=False,
                                     output_motion=False, log_fn=jlines.append) == 16
    want = _artifacts(jout)
    assert sorted(want) == sorted(outs[8])
    for n, w in want.items():
        assert outs[8][n].shape == w.shape == (6, 16, 2, 2)
        assert np.abs(outs[8][n] - w).max() <= 1e-4 * np.abs(w).max()
    for got in (lines[8], lines[16], jlines):
        assert len(got) == 1 and got[0].startswith(f"{video}: 16 frames in ")


def test_extract_video_resume_skips_and_no_resume_rewrites(model, video, tmp_path):
    out = str(tmp_path / "vid")
    cfg = _cfg()
    assert extract.extract_video(model, cfg, video, out, output_img=False, max_frames=7,
                                 log_fn=lambda _: None) == 6
    first = _artifacts(out)
    stale = os.path.join(out, "cube_feat", "000004.npy")
    np.save(stale, np.zeros_like(first["000004.npy"]))
    # resume (the default) counts the stale file as complete and keeps it
    assert extract.extract_video(model, cfg, video, out, output_img=False, max_frames=7,
                                 log_fn=lambda _: None) == 6
    assert not np.load(stale).any()
    assert extract.extract_video(model, cfg, video, out, output_img=False, max_frames=7,
                                 resume=False, log_fn=lambda _: None) == 6
    _same_artifacts(_artifacts(out), first)


@pytest.mark.parametrize("remap", [False, True])
def test_upload_depth_keeps_the_artifacts(model, tmp_path, remap):
    """9 frames in batches of 2 (4 batches and a tail of 1) at upload
    depths 1 and 4, and at 4 beside a fetch depth of 2: bit for bit."""
    frames = _frames(10, seed=remap)
    outs = []
    for depth, fetch in ((1, 1), (4, 1), (4, 2)):
        out = str(tmp_path / f"d{depth}f{fetch}")
        cfg = _cfg(host_cube_remap=remap, upload_depth=depth, fetch_depth=fetch)
        assert extract.extract_frames(model, cfg, iter(frames), out, output_img=False,
                                      batch_frames=2, log_fn=lambda _: None) == 9
        outs.append(_artifacts(out))
    for other in outs[1:]:
        _same_artifacts(other, outs[0])


# ---- infer_video's prefetch depth --------------------------------------------------


@pytest.fixture(scope="module")
def feat_dir(tmp_path_factory):
    rng = np.random.RandomState(13)
    feat = tmp_path_factory.mktemp("params_feat") / "cube_feat"
    feat.mkdir()
    for i in range(2, 2 + 14):
        np.save(feat / f"{i:06}.npy", rng.gamma(0.5, 2.0, (6, 8, 7, 7)).astype(np.float16))
    return str(feat)


def test_infer_video_prefetch_depths_equal_jax(feat_dir):
    """9 windows in batches of 2 at prefetch depths 1 and 3 (the default):
    bit for bit alike, and within 1e-5 of the JAX package's at the same
    depths."""
    tree = jax_params.init_clstm_params(5, 8, 8)
    cell = jax_params.clstm_from_params(tree, torch.float32)
    got = {d: temporal.infer_video(cell, feat_dir, T, batch_windows=2, prefetch_depth=d)
           for d in (1, 3)}
    assert got[3].keys() == got[1].keys() == set(range(9))
    for k in got[1]:
        _equal(got[1][k], got[3][k])
    for d in (1, 3):
        want = jax_temporal.infer_video(_jax(tree), feat_dir, T, batch_windows=2,
                                        compute_dtype=jnp.float32, prefetch_depth=d)
        assert sorted(want) == sorted(got[d])
        for k in want:
            np.testing.assert_allclose(got[d][k], want[k], atol=1e-5, rtol=0)


# ---- the single-pair flow solvers' parameters -----------------------------------------


@pytest.mark.parametrize("backend,args", [
    ("horn_schunck", (0.2, 2, 6, 1, False, False)),
    ("variational", (0.03, 0.4, 2, 1, 2, 4, True, False)),
])
def test_single_pair_flow_takes_the_jax_parameters(backend, args):
    """The solver's own parameters, positionally as in the JAX signature:
    the port's single pair equals its batch of one bit for bit and lies
    within 1e-3 px of the JAX package's single pair."""
    rng = np.random.RandomState(3)
    base = rng.rand(24, 40).astype(np.float32)
    prev, cur = base, np.roll(base, 1, axis=1)
    mine, mine_batch, theirs = ((flow.horn_schunck_flow, flow.horn_schunck_flow_batch,
                                 jflow.horn_schunck_flow) if backend == "horn_schunck" else
                                (var.brox_flow, var.brox_flow_batch, jvar.brox_flow))
    got = mine(torch.from_numpy(prev), torch.from_numpy(cur), *args)
    batch = mine_batch(torch.from_numpy(prev[None]), torch.from_numpy(cur[None]), *args)
    want = np.asarray(theirs(jnp.asarray(prev), jnp.asarray(cur), *args))
    assert tuple(got.shape) == (24, 40, 2) and got.dtype == torch.float32
    _equal(got.numpy(), batch[0].numpy())
    assert np.abs(got.numpy() - want).max() <= 1e-3
