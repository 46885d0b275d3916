"""PyTorch port, the trainer's options against the JAX package on the CPU:
segment windows, the int8 loader codec, in-training validation, profiles
and supervision.

Sizes are cut for the CPU (CAM channels 16 on 7x7 faces, ConvLSTM 16/16,
flows 16x32); the code paths are the full-width ones.  Inputs come from
seeded numpy.  Tolerances: the segment step against the port's direct step
as ``tests/test_train_segment.py`` holds the JAX one (loss 1e-6 relative,
weights 1e-5 / 1e-7); against the JAX segment step as
``tests/test_torch_train.py`` holds the port's step against JAX's (losses
1e-4 relative, weights 5e-4); datasets and loader batches bit for bit; the
validation aggregate to 1e-6 against the JAX package's.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.data import dataset as jax_dataset
from cp360_tpu.ops.quantize import Quantized as JaxQuantized
from cp360_tpu.train import loop as jax_loop
from cp360_tpu.train import validate as jax_validate
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.data.dataset import PrefetchLoader, SegmentWindowDataset, WindowDataset
from cp360_tpu_torch.ops.quantize import Quantized, maybe_dequantize, quantize_cam_np
from cp360_tpu_torch.train import loop, validate
from cp360_tpu_torch.utils import supervise as sup
from cp360_tpu_torch.utils.profiling import annotate, maybe_profile

torch.set_num_threads(2)

C = 16
T = 5
N_FRAMES = 11  # artifact indices 2..12


def _expand_np(x, group):
    t = x.shape[1] - group + 1
    return np.stack([x[s, k:k + t] for s in range(x.shape[0]) for k in range(group)])


def _records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


# ---- segment windows and the int8 codec in the train step ---------------------


@pytest.mark.parametrize("group", [1, 2, 5])
def test_expand_segments_equals_jax(group):
    x = np.random.RandomState(0).rand(3, 9, 6, 2, 2, 4).astype(np.float32)
    got = loop.expand_segments(torch.from_numpy(x), group).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_loop.expand_segments(jnp.asarray(x),
                                                                           group)))
    np.testing.assert_array_equal(got, _expand_np(x, group))


def test_maybe_dequantize():
    x = np.random.RandomState(1).randn(2, 6, 7, 7, 5).astype(np.float32)
    q = Quantized(*quantize_cam_np(x)).to("cpu")
    assert q.q.dtype == torch.int8 and q.scales.dtype == torch.float32
    got = maybe_dequantize(q)
    np.testing.assert_array_equal(got.numpy(), q.q.numpy().astype(np.float32) * q.scales.numpy())
    half = torch.from_numpy(x).half()
    assert maybe_dequantize(half).dtype == torch.float32
    np.testing.assert_array_equal(maybe_dequantize(half).numpy(), half.float().numpy())


def _segment_batch(seed=1, group=4, n_seg=2):
    rng = np.random.RandomState(seed)
    f = group + T - 1
    seq = rng.rand(n_seg, f, 6, 7, 7, C).astype(np.float32)
    flows = (rng.randn(n_seg, f, 16, 32, 2) * 2).astype(np.float32)
    return seq, flows


def _encode(codec, seq, flows, wrap=Quantized):
    """The codec as tests/test_train_segment.py applies it: both batches int8."""
    if codec == "int8":
        return wrap(*quantize_cam_np(seq)), wrap(*quantize_cam_np(flows))
    return seq, flows


def _port_step(cfg, params, seq, flows):
    model = loop.trainable_clstm(cfg, params, "cpu")
    opt = loop.make_optimizer(cfg, model)
    seq, flows = (loop.batch_to_device(a, torch.device("cpu")) for a in (seq, flows))
    metrics = loop.make_train_step(cfg, model, opt)(seq, flows)
    return jax_params.clstm_to_params(model), metrics


_BASE = dict(input_size=C, hidden_size=C, flow_h=16, lr=1e-3, compute_dtype="float32",
             seq_len=T)


def test_training_leaves_the_callers_params_alone():
    """A fault the port had: on the CPU the f32 masters shared memory with
    the caller's numpy param tree, so a step rewrote it (and a tree taken
    by clstm_to_params moved with later steps); the JAX package's trees
    are values."""
    params = jax_params.init_clstm_params(0, C, C)
    before = {n: {k: v.copy() for k, v in p.items()} for n, p in params.items()}
    cfg = Config(**_BASE)
    model = loop.trainable_clstm(cfg, params, "cpu")
    step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
    seq, flows = _segment_batch(group=1)
    step(torch.from_numpy(seq), torch.from_numpy(flows))
    taken = jax_params.clstm_to_params(model)
    snapshot = {n: {k: v.copy() for k, v in p.items()} for n, p in taken.items()}
    step(torch.from_numpy(seq), torch.from_numpy(flows))
    for name in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(params[name][k], before[name][k])
            np.testing.assert_array_equal(taken[name][k], snapshot[name][k])
            assert not np.array_equal(taken[name][k], before[name][k])


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_segment_step_equals_direct_step(codec):
    """One Adam step fed 2 segments of 4 windows equals the step fed the 8
    expanded windows (the int8 scales are per frame plane, so the segment's
    one quantized copy dequantizes to what each window's own copy would)."""
    group = 4
    seq_seg, flows_seg = _segment_batch()
    params = jax_params.init_clstm_params(0, C, C)
    cfg = Config(**_BASE)
    p_seg, m_seg = _port_step(cfg.replace(segment_windows=group),
                              params, *_encode(codec, seq_seg, flows_seg))
    p_dir, m_dir = _port_step(cfg, params, *_encode(codec, _expand_np(seq_seg, group),
                                                    _expand_np(flows_seg, group)))
    np.testing.assert_allclose(float(m_seg["loss"]), float(m_dir["loss"]), rtol=1e-6)
    for name in p_dir:
        for k in ("w", "b"):
            np.testing.assert_allclose(p_seg[name][k], p_dir[name][k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_segment_step_equals_jax_segment_step(codec):
    group = 4
    seq_seg, flows_seg = _segment_batch(seed=2)
    params = jax_params.init_clstm_params(3, C, C)
    jcfg = JaxConfig(**_BASE, segment_windows=group)
    jopt = jax_loop.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp2, _, jm = jax_loop.make_train_step(jcfg, jopt)(
        jp, jopt.init(jp), *_encode(codec, seq_seg, flows_seg, JaxQuantized))
    got, m = _port_step(Config(**_BASE, segment_windows=group), params,
                        *_encode(codec, seq_seg, flows_seg))
    for key in ("loss", "smooth", "temporal", "mask"):
        want = float(jm[key])
        assert abs(float(m[key]) - want) <= 1e-4 * abs(want), key
    for name in got:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[name][k], np.asarray(jp2[name][k]), atol=5e-4,
                                       rtol=5e-4, err_msg=f"{name}/{k}")


# ---- the segment dataset and the loader ----------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Two videos of f32 CAM cubes and flows, numbered 000002..000012."""
    root = tmp_path_factory.mktemp("opt_artifacts")
    rng = np.random.RandomState(0)
    for vid in ("vidA", "vidB"):
        for sub in ("cube_feat", "motion"):
            (root / vid / sub).mkdir(parents=True)
        for t in range(2, 2 + N_FRAMES):
            np.save(root / vid / "cube_feat" / f"{t:06}.npy",
                    rng.gamma(0.5, 2.0, (6, C, 7, 7)).astype(np.float32))
            np.save(root / vid / "motion" / f"{t:06}.npy",
                    (rng.randn(16, 32, 2) * 5).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def gappy(artifacts, tmp_path_factory):
    root = tmp_path_factory.mktemp("opt_gappy")
    shutil.copytree(artifacts / "vidA", root / "vidA")
    os.remove(root / "vidA" / "cube_feat" / "000005.npy")
    return root


@pytest.mark.parametrize("where,group", [("artifacts", 2), ("artifacts", 3),
                                         ("artifacts", 4), ("gappy", 2)])
def test_segment_dataset_equals_jax(request, where, group):
    root = str(request.getfixturevalue(where))
    vids = sorted(os.listdir(root))
    ds = SegmentWindowDataset(WindowDataset(root, None, vids, T), group)
    jds = jax_dataset.SegmentWindowDataset(jax_dataset.WindowDataset(root, None, vids, T), group)
    assert ds.segments == jds.segments and ds.n_windows == jds.n_windows and len(ds)
    if where == "gappy":  # starts 2,3,4,6,7 (5 is missing): runs [2..4], [6..7]
        assert ds.segments == [("vidA", 2), ("vidA", 6)]
        # a window over the hole raises in both packages (the JAX one's
        # native reader with a plain OSError)
        with pytest.raises(FileNotFoundError, match="missing CAM frame"):
            ds.get_batch([0])
        with pytest.raises(OSError, match="000005.npy"):
            jds.get_batch([0])
        return
    idxs = np.arange(len(ds))[::-1]
    for a, b in zip(ds.get_batch(idxs, n_threads=3), jds.get_batch(idxs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_threaded_reads_equal_serial_reads(artifacts):
    ds = WindowDataset(str(artifacts), None, ["vidA", "vidB"], T)
    for a, b in zip(ds.get_batch([5, 0, 9], n_threads=4), ds.get_batch([5, 0, 9])):
        np.testing.assert_array_equal(a, b)
    seq, flows, vid, start = ds[3]
    assert (vid, start) == ds.windows[3] and seq.shape == (T, 6, 7, 7, C)
    with pytest.raises(FileNotFoundError, match="missing CAM frame"):
        WindowDataset(str(artifacts), None, ["vidA"], 20).read_runs([("vidA", 2)], 20)


@pytest.mark.parametrize("segments", [False, True])
def test_int8_loader_batches_equal_jax(artifacts, segments):
    """q, scales and the f16 flows, bit for bit, in the same order."""
    vids = ["vidA", "vidB"]
    ds = WindowDataset(str(artifacts), None, vids, T)
    jds = jax_dataset.WindowDataset(str(artifacts), None, vids, T)
    if segments:
        ds, jds = SegmentWindowDataset(ds, 3), jax_dataset.SegmentWindowDataset(jds, 3)
    kw = dict(batch_size=2, shuffle=True, seed=5, transfer_codec="int8")
    loader = PrefetchLoader(ds, num_threads=2, **kw)
    jloader = jax_dataset.PrefetchLoader(jds, **kw)
    got, want = list(loader.iter_epoch(1)), list(jloader.iter_epoch(1))
    assert len(got) == len(want) == len(loader) == len(jloader) > 0
    for (seq, flows), (jseq, jflows) in zip(got, want):
        assert isinstance(seq, Quantized) and isinstance(jseq, JaxQuantized)
        assert seq.q.dtype == np.int8 and flows.dtype == np.float16 == jflows.dtype
        for a, b in ((seq.q, jseq.q), (seq.scales, jseq.scales), (flows, jflows)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_cli_trains_segments_with_the_int8_codec(artifacts, tmp_path):
    from cp360_tpu_torch.cli import train_temporal

    from cp360_tpu_torch.data.dataset import builtin_split

    root = tmp_path / "art"
    shutil.copytree(artifacts / "vidA", root / builtin_split("train_60")[0])
    metrics = tmp_path / "m.jsonl"
    argv = ["--input", str(root), "--device", "cpu", "--metrics-jsonl", str(metrics),
            "--set", f"input_size={C}", "--set", f"hidden_size={C}", "--set", "flow_h=16",
            "--set", "summary_freq=1", "--set", "epochs=1", "--set", "batch_size=2",
            "--set", f"checkpoint_path={tmp_path / 'ck'}", "--set", "processes=2",
            "--set", "segment_windows=2", "--set", "transfer_codec=int8"]
    out = train_temporal.main(argv)
    recs = _records(metrics)
    assert len(recs) == 3 and all(np.isfinite(r["loss_avg"]) for r in recs)  # 6 windows
    init = jax_params.init_clstm_params(0, C, C)
    assert not np.array_equal(out["gates"]["w"], init["gates"]["w"])
    with pytest.raises(SystemExit, match="divisible by segment_windows"):
        train_temporal.main(argv[:-4] + ["--set", "segment_windows=4"])


# ---- in-training validation ---------------------------------------------------


@pytest.fixture(scope="module")
def gt_root(tmp_path_factory):
    """GT maps for every window end id of the artifacts (seq_len 3)."""
    root = tmp_path_factory.mktemp("opt_gt")
    rng = np.random.RandomState(7)
    for vid in ("vidA", "vidB"):
        (root / f"{vid}.mp4").mkdir()
        for i in range(N_FRAMES):
            np.save(root / f"{vid}.mp4" / f"{i:05}.npy",
                    (rng.rand(10, 20) ** 4).astype(np.float32))
    return root


def _val_kw(artifacts, gt_root, **kw):
    return {**dict(input_size=C, hidden_size=C, seq_len=3, compute_dtype="float32",
                   eval_every_epochs=1, eval_dir=str(artifacts), label_path=str(gt_root),
                   eval_batch_windows=4), **kw}


def test_run_validation_equals_jax(artifacts, gt_root, tmp_path):
    params = jax_params.init_clstm_params(4, C, C)
    cfg, jcfg = Config(**_val_kw(artifacts, gt_root)), JaxConfig(**_val_kw(artifacts, gt_root))
    assert validate.validation_videos(cfg) == jax_validate.validation_videos(jcfg) == [
        "vidA", "vidB"]
    quiet = dict(log_fn=lambda *a: None)
    agg = validate.run_validation(params, cfg, device="cpu", **quiet)
    want = jax_validate.run_validation(params, jcfg, **quiet)
    assert agg["videos"] == want["videos"] == 2
    assert agg["windows"] == want["windows"] == 2 * (N_FRAMES - 3)
    for k in ("AUC", "AUCB", "CC", "SIM"):
        assert abs(agg[k] - want[k]) <= 1e-6, (k, agg[k], want[k])
    capped = cfg.replace(eval_max_videos=1)
    assert validate.validation_videos(capped) == jax_validate.validation_videos(
        jcfg.replace(eval_max_videos=1)) == ["vidA"]
    # no matching split, no GT: None, as the JAX package
    for kw in (dict(eval_split="test_25"), dict(label_path=str(tmp_path / "nogt"))):
        assert validate.run_validation(params, cfg.replace(**kw), device="cpu", **quiet) is None
        assert jax_validate.run_validation(params, jcfg.replace(**kw), **quiet) is None


class _OneWindow:
    """A loader of one seeded window (seq_len 3, flows 8x16) per epoch."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.batch = (rng.rand(1, 3, 6, 7, 7, C).astype(np.float32),
                      (rng.randn(1, 3, 8, 16, 2) * 0.1).astype(np.float32))

    def __len__(self):
        return 1

    def iter_epoch(self, epoch, skip_batches=0):
        return iter([self.batch][skip_batches:])


def _train(cfg, tmp_path, name="m.jsonl", **kw):
    path = tmp_path / name
    params = loop.train(cfg, _OneWindow(), params=jax_params.init_clstm_params(0, C, C),
                        device="cpu", log_fn=lambda *a, **k: None, metrics_jsonl=str(path),
                        **kw)
    return params, _records(path)


def _train_cfg(artifacts, gt_root, tmp_path, **kw):
    return Config(**_val_kw(artifacts, gt_root, flow_h=8, batch_size=1, summary_freq=1,
                            save_freq=10**9, checkpoint_path=str(tmp_path / "ck"), **kw))


def test_train_validates_and_keeps_best(artifacts, gt_root, tmp_path):
    cfg = _train_cfg(artifacts, gt_root, tmp_path, epochs=2)
    _, recs = _train(cfg, tmp_path)
    vals = [r for r in recs if r["event"] == "val"]
    assert [v["epoch"] for v in vals] == [0, 1] and vals[0]["best"] is True
    assert vals[0]["videos"] == 2 and 0.0 <= vals[0]["AUC"] <= 1.0
    ckdir = loop.checkpoint_dir(cfg)
    best = jax_params.load_npz(os.path.join(ckdir, "best.npz"))
    assert best["gates"]["w"].shape == (3, 3, 4 * C, 4 * C)
    meta = json.load(open(os.path.join(ckdir, "best_val.json")))
    assert meta["auc"] == max(v["AUC"] for v in vals) and meta["epoch"] == 1

    # a resumed run whose pass does not beat the recorded AUC keeps best.npz
    sentinel = b"sentinel-best-params"
    with open(os.path.join(ckdir, "best.npz"), "wb") as f:
        f.write(sentinel)
    json.dump({"auc": 2.0, "evals_since_best": 0}, open(os.path.join(ckdir, "best_val.json"), "w"))
    _, recs = _train(cfg.replace(epochs=3), tmp_path, "m2.jsonl", resume_state="latest")
    vals = [r for r in recs if r["event"] == "val"]
    assert [v["epoch"] for v in vals] == [2] and vals[0]["best"] is False
    assert open(os.path.join(ckdir, "best.npz"), "rb").read() == sentinel
    assert json.load(open(os.path.join(ckdir, "best_val.json")))["evals_since_best"] == 1


def test_validation_leaves_the_training_unchanged(artifacts, gt_root, tmp_path):
    """The pass reads a host copy of the weights: the next steps give the
    same update as a run without validation, bit for bit."""
    cfg = _train_cfg(artifacts, gt_root, tmp_path, epochs=3)
    with_val, _ = _train(cfg, tmp_path)
    without, _ = _train(cfg.replace(eval_every_epochs=0, checkpoint_path=str(tmp_path / "ck2")),
                        tmp_path, "m2.jsonl")
    for name in with_val:
        for k in ("w", "b"):
            np.testing.assert_array_equal(with_val[name][k], without[name][k])


def test_train_stops_early_at_patience(artifacts, gt_root, tmp_path):
    # lr 0: the weights never change, so every pass replays the first AUC
    cfg = _train_cfg(artifacts, gt_root, tmp_path, epochs=50, lr=0.0, eval_patience=2)
    _, recs = _train(cfg, tmp_path)
    vals = [r for r in recs if r["event"] == "val"]
    stops = [r for r in recs if r["event"] == "train_early_stop"]
    assert [v["best"] for v in vals] == [True, False, False]
    assert len(stops) == 1 and stops[0]["epoch"] == 2


def test_failed_validation_is_logged_and_training_goes_on(artifacts, gt_root, tmp_path,
                                                          monkeypatch):
    def broken(*a, **k):
        raise OSError("corrupt artifact")

    monkeypatch.setattr(validate, "run_validation", broken)
    cfg = _train_cfg(artifacts, gt_root, tmp_path, epochs=2)
    _, recs = _train(cfg, tmp_path)
    errors = [r for r in recs if r["event"] == "val_error"]
    assert [r["epoch"] for r in errors] == [0, 1] and "corrupt artifact" in errors[0]["error"]
    assert [r["epoch"] for r in recs if r["event"] == "train"] == [0, 1]
    assert os.path.exists(os.path.join(loop.checkpoint_dir(cfg), "epoch_01.npz"))


# ---- profiles ------------------------------------------------------------------


def test_maybe_profile_writes_a_trace(tmp_path):
    with maybe_profile(str(tmp_path / "prof")), annotate("cp360_span"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(tmp_path / "prof")
    text = (tmp_path / "prof" / trace).read_text()
    assert "cp360_span" in text and "aten::mm" in text
    json.loads(text)
    with maybe_profile(None):  # off: nothing written, nothing raised
        pass


@pytest.mark.parametrize("interrupted", [False, True])
def test_train_profile_dir_traces_the_epochs(artifacts, gt_root, tmp_path, monkeypatch,
                                             interrupted):
    """The trace is written when the epochs end, and when a shutdown
    request ends them early (the loop's return after its train state)."""
    if interrupted:
        class Requested(loop.GracefulShutdown):
            def __enter__(self):
                self.requested = True
                return self

        monkeypatch.setattr(loop, "GracefulShutdown", Requested)
    cfg = _train_cfg(artifacts, gt_root, tmp_path, epochs=2, eval_every_epochs=0,
                     profile_dir=str(tmp_path / "prof"))
    _, recs = _train(cfg, tmp_path)
    assert [r["event"] for r in recs] == (["train", "train_interrupted"] if interrupted
                                          else ["train", "train"])
    (trace,) = os.listdir(tmp_path / "prof")
    assert "aten::" in (tmp_path / "prof" / trace).read_text()


# ---- supervision (tests/test_supervise.py's cases, on the port's copy) ----------

STALL_THEN_FINISH = """
import os, sys, time
print("child started", flush=True)
out, marker = sys.argv[1], sys.argv[2]
if not os.path.exists(marker):
    open(marker, "w").write("x")
    open(os.path.join(out, "000002.npy"), "w").write("partial")
    time.sleep(600)
open(os.path.join(out, "000003.npy"), "w").write("done")
print("finished")
"""

CRASH_THEN_FINISH = """
import os, sys
out, marker = sys.argv[1], sys.argv[2]
if not os.path.exists(marker):
    open(marker, "w").write("x")
    sys.exit(3)
open(os.path.join(out, "done.npy"), "w").write("done")
"""


def _supervise(tmp_path, script, **kw):
    out = tmp_path / "arts"
    out.mkdir(exist_ok=True)
    logs = []
    rc = sup.supervise([sys.executable, "-c", script, str(out), str(tmp_path / "marker")],
                       watch_paths=[str(out)], log=logs.append, **kw)
    return rc, out, logs


@pytest.mark.parametrize("case", ["stall", "crash", "give_up"])
def test_supervise_restarts(tmp_path, case):
    if case == "stall":
        rc, out, logs = _supervise(tmp_path, STALL_THEN_FINISH, stall_timeout_s=6.0, poll_s=0.3,
                                   grace_s=2.0, max_restarts=2)
        assert rc == 0 and (out / "000003.npy").exists()
        assert any("no progress" in m for m in logs)
        assert any("completed after 1 restart" in m for m in logs)
    elif case == "crash":
        rc, out, logs = _supervise(tmp_path, CRASH_THEN_FINISH, stall_timeout_s=30.0,
                                   poll_s=0.2, max_restarts=2, fast_fail_backoff_s=0.2)
        assert rc == 0 and (out / "done.npy").exists()
        assert any("fast failure" in m for m in logs)
    else:
        rc, _, logs = _supervise(tmp_path, "import sys; sys.exit(7)", stall_timeout_s=30.0,
                                 poll_s=0.2, max_restarts=1, fast_fail_backoff_s=0.1)
        assert rc == 7 and any("giving up" in m for m in logs)


def test_strip_supervise_flag():
    assert sup.strip_supervise_flag(["--out", "s", "--supervise", "-of"]) == ["--out", "s", "-of"]
    assert sup.strip_supervise_flag(["--supervise", "300", "-of"]) == ["-of"]
    assert sup.strip_supervise_flag(["--supervise=300", "-of", "--out", "s"]) == [
        "-of", "--out", "s"]


@pytest.mark.parametrize("cli,argv,resume", [
    ("train_temporal", ["--input", "static", "--metrics-jsonl", "m.jsonl"], True),
    ("extract_features", ["--out", "static", "-of"], False),
    ("test_temporal", ["--model", "x.npz", "--dir", "d"], True),
    ("stream_saliency", ["--video", "v.mp4", "--backbone", "b.npz", "--clstm", "c.npz",
                         "--out", "sal"], True),
])
def test_supervised_child_is_the_port_module(tmp_path, monkeypatch, cli, argv, resume):
    """Every CLI's --supervise relaunches the port's own module (never the
    JAX package's), without --supervise, with --resume where a restart
    must continue, watching the job's outputs."""
    import importlib

    monkeypatch.chdir(tmp_path)  # no ./config.yaml: built-in defaults
    captured = {}

    def fake(cmd, watch_paths, stall_timeout_s, **kw):
        captured.update(cmd=cmd, watch=watch_paths, stall=stall_timeout_s, grace=kw["grace_s"])
        return 0

    monkeypatch.setattr(sup, "supervise", fake)
    mod = importlib.import_module(f"cp360_tpu_torch.cli.{cli}")
    full = argv + ["--supervise", "77", "--set", f"output_path={tmp_path}"]
    with pytest.raises(SystemExit) as ei:
        mod.main(full)
    assert ei.value.code == 0
    cmd = captured["cmd"]
    assert cmd[:3] == [sys.executable, "-m", f"cp360_tpu_torch.cli.{cli}"]
    assert "--supervise" not in cmd and "77" not in cmd and captured["stall"] == 77.0
    assert ("--resume" in cmd) == resume
    if cli == "train_temporal":
        assert captured["grace"] == 60.0 and "m.jsonl" in captured["watch"]
        assert captured["watch"][0] == loop.checkpoint_dir(Config(output_path=str(tmp_path)))
    if cli == "extract_features":
        assert captured["watch"] == [os.path.join(str(tmp_path), "static_resnet50")]
    with pytest.raises(ValueError, match="not a cp360_tpu_torch module"):
        sup.run_supervised("cp360_tpu.cli.train_temporal", [], [], 1.0)
