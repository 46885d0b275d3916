"""PyTorch port, scale-out in one process, against the JAX package on the CPU.

The pipe (``parallel/pipeline.py``) runs on ``["cpu"] * P`` against JAX's
``pipelined_rollout`` on the 8-device virtual CPU mesh of
tests/conftest.py; the local replicas (``parallel/mesh.py::LocalReplicas``)
run on ``["cpu", "cpu"]``.  Inputs are numpy from a seed, widths are cut
for the CPU (ConvLSTM 8 or 16 channels), the math is f32.

Tolerances: the pipe against JAX's at 1e-6 (the rollout) and 1e-5 (window
inference), as tests/test_pipeline_parallel.py holds JAX's pipe against its
serial scan; against the port's own serial forms bit for bit (the same ops
on each microbatch, and the plain CPU conv does not depend on the batch);
the pipelined train step against the serial one at rtol 1e-6 (loss) and
atol 1e-6 on the SGD update lr * g at lr 1e-3 (the microbatches sum their
weight gradients in another order), as tests/test_pipeline_parallel.py
compares JAX's post-SGD params, and against JAX's step at the tolerances
tests/test_torch_train.py holds a port step to (1e-4 on the losses; the
SGD-sized update lr * g at 5e-4 of its largest entry); the replicas bit for
bit against one device.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.parallel import pipeline as jax_pipeline
from cp360_tpu.parallel.mesh import make_mesh
from cp360_tpu.pipelines import temporal as jax_temporal
from cp360_tpu.train import loop as jax_loop
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.models.clstm import clstm_rollout
from cp360_tpu_torch.parallel import mesh
from cp360_tpu_torch.parallel.pipeline import make_pipe_devices, pipelined_rollout
from cp360_tpu_torch.pipelines import extract, temporal
from cp360_tpu_torch.serving.server import SaliencyModel
from cp360_tpu_torch.train import loop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU2 = ["cpu", "cpu"]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _cell(params, trainable=False):
    return jax_params.clstm_from_params(params, torch.float32, trainable=trainable)


@pytest.fixture(scope="module")
def rollout_case():
    params = jax_params.init_clstm_params(0, 8, 8)
    seq = np.random.RandomState(0).rand(8, 4 * 6, 7, 7, 8).astype(np.float32)
    return params, seq


# ---- the pipe ----------------------------------------------------------------------


@pytest.mark.parametrize("n_pipe,n_micro", [(4, 2), (2, 4), (8, 1)])
def test_pipelined_rollout_equals_jax_and_serial(rollout_case, n_pipe, n_micro):
    params, seq = rollout_case
    jhs, jh, jc = jax_pipeline.pipelined_rollout(
        _jax(params), jnp.asarray(seq), jnp.asarray(seq[0]), jnp.asarray(seq[0]),
        jax_pipeline.make_pipe_mesh(n_pipe), n_micro=n_micro)
    cell = _cell(params)
    tseq = torch.from_numpy(seq)
    with torch.no_grad():
        hs, h, c = pipelined_rollout(cell, tseq, tseq[0], tseq[0], ["cpu"] * n_pipe, n_micro)
        shs, sh, sc = clstm_rollout(cell, tseq, tseq[0], tseq[0])
    tc = seq.shape[0] // n_pipe
    assert hs.shape == (tc, 24, 7, 7, 8)
    for got, want in ((hs, jhs), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for got, want in ((hs, shs[-tc:]), (h, sh), (c, sc)):
        assert torch.equal(got, want)


def test_window_infer_pipelined_equals_jax_and_serial():
    params = jax_params.init_clstm_params(1, 8, 8)
    windows = np.random.RandomState(3).rand(4, 5, 6, 7, 7, 8).astype(np.float32)
    want = jax_temporal.window_infer_pipelined(
        _jax(params), jnp.asarray(windows), jax_pipeline.make_pipe_mesh(5), n_micro=2,
        compute_dtype=jnp.float32)
    cell = _cell(params)
    tw = torch.from_numpy(windows)
    with torch.no_grad():
        got = temporal.window_infer_pipelined(cell, tw, ["cpu"] * 5, 2)
        serial = temporal.window_infer(cell, tw)
        frames = torch.from_numpy(windows[:, 0].copy())  # a frame run: windows at 0..B-5
        run = torch.cat([frames, torch.from_numpy(windows[-1, 1:])])
        pos = torch.arange(run.shape[0] - 4)
        got_f = temporal.window_infer_from_frames_pipelined(cell, run, pos, ["cpu"] * 5, 2)
        want_f = temporal.window_infer_from_frames(cell, run, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, serial) and torch.equal(got_f, want_f)


def _train_case(seed=7, b=4, t=8, ch=8):
    rng = np.random.RandomState(seed)
    seq = rng.rand(b, t, 6, 7, 7, ch).astype(np.float32)
    flows = (rng.randn(b, t, 16, 32, 2) * 2).astype(np.float32)
    params = jax_params.init_clstm_params(0, ch, ch)
    return params, seq, flows


def _port_grads(cfg, params, seq, flows):
    model = loop.trainable_clstm(cfg, params, "cpu")
    step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
    m = step(torch.from_numpy(seq), torch.from_numpy(flows))
    return m, {f"{n}/{k}": getattr(model, f"{n}_{k}").grad.numpy()
               for n in ("conv1", "conv2", "gates") for k in ("w", "b")}


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_train_step_equals_serial_and_jax(remat):
    """seq_len 8 over 2 stages leaves a 4-step last chunk, exactly the
    TMP_LOSS_LEN+1 steps the losses consume (tests/test_pipeline_parallel.py)."""
    params, seq, flows = _train_case()
    base = Config(input_size=8, hidden_size=8, flow_h=16, lr=1e-3, compute_dtype="float32",
                  seq_len=8, train_remat=remat)
    m1, g1 = _port_grads(base, params, seq, flows)
    m2, g2 = _port_grads(base.replace(pipeline_stages=2, pipeline_microbatches=2), params,
                         seq, flows)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    for k in g1:  # the SGD update lr * g, as tests/test_pipeline_parallel.py compares
        np.testing.assert_allclose(base.lr * g2[k], base.lr * g1[k], atol=1e-6, err_msg=k)

    jcfg = JaxConfig(input_size=8, hidden_size=8, flow_h=16, lr=1e-3, compute_dtype="float32",
                     seq_len=8, pipeline_stages=2, pipeline_microbatches=2)
    opt = optax.sgd(jcfg.lr)
    jp = _jax(params)
    jp2, _, jm = jax_loop.make_train_step(jcfg, opt)(jp, opt.init(jp), jnp.asarray(seq),
                                                     jnp.asarray(flows))
    assert abs(float(m2["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    for name in ("conv1", "conv2", "gates"):
        for key in ("w", "b"):
            want = params[name][key] - np.asarray(jp2[name][key])  # jp was donated
            got = jcfg.lr * g2[f"{name}/{key}"]
            assert np.abs(got - want).max() <= 5e-4 * np.abs(want).max(), (name, key)


def test_pipe_refusals_use_jax_words(rollout_case):
    params, seq = rollout_case
    cell = _cell(params)
    # T=8 over 3 stages; B=24 in 5 microbatches; 3 windows in 2 microbatches of 9 rows
    for t, rows, n_pipe, n_micro in ((8, 24, 3, 1), (8, 24, 2, 5), (8, 18, 2, 2)):
        x = torch.from_numpy(seq[:t, :rows])
        with pytest.raises(ValueError) as mine:
            pipelined_rollout(cell, x, x[0], x[0], ["cpu"] * n_pipe, n_micro)
        xj = jnp.asarray(x.numpy())
        with pytest.raises(ValueError) as theirs:
            jax_pipeline.pipelined_rollout(_jax(params), xj, xj[0], xj[0],
                                           jax_pipeline.make_pipe_mesh(n_pipe), n_micro)
        assert str(mine.value) == str(theirs.value)
    # the published seq_len=5 cannot pipeline training for any P > 1
    with pytest.raises(ValueError, match="seq_len=5 cannot pipeline"):
        loop.make_train_step(Config(seq_len=5, pipeline_stages=5), None, None)
    with pytest.raises(ValueError) as theirs:
        jax_loop.make_train_step(JaxConfig(seq_len=5, pipeline_stages=5), optax.sgd(1e-3))
    with pytest.raises(ValueError) as mine:
        loop.check_config(Config(seq_len=5, pipeline_stages=5))
    assert str(mine.value) == str(theirs.value)
    # more stages than cards: JAX's words, before anything runs
    with pytest.raises(ValueError, match=r"pipeline_stages=99 but only \d+ device\(s\)"):
        make_pipe_devices(99, "cuda")
    assert make_pipe_devices(3, "cpu") == [torch.device("cpu")] * 3


def _stream_video(path, n=12):
    import cv2

    rng = np.random.RandomState(5)
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (256, 128))
    base = (rng.rand(128, 256, 3) * 255).astype(np.uint8)
    for t in range(n):
        vw.write(np.roll(base, 9 * t, axis=1))
    vw.release()
    return str(path)


def test_stream_pipeline_stages_equals_serial(tmp_path):
    """``pipeline_stages`` routes the stream's window batches through the
    pipe; the maps equal the serial stream's (tests/test_pipeline_parallel.py)."""
    from cp360_tpu_torch.pipelines.stream import stream_video_saliency

    path = _stream_video(tmp_path / "v.mp4")
    cfg = Config(equi_h=256, equi_w=128, cube_dim=64, seq_len=5, compute_dtype="float32",
                 opt_flow=False)
    backbone = jax_params.backbone_from_params(
        jax_params.init_resnet_params(0, "resnet18", num_classes=16), "resnet18",
        compute_dtype=torch.float32)
    cell = _cell(jax_params.init_clstm_params(1, 16, 16))
    serial = dict(stream_video_saliency(backbone, cell, path, cfg, stage1_batch=4))
    piped = dict(stream_video_saliency(backbone, cell, path, cfg.replace(pipeline_stages=5),
                                       stage1_batch=4))
    assert sorted(piped) == sorted(serial) and len(serial) == 7
    for k in serial:
        np.testing.assert_array_equal(piped[k], serial[k])
    with pytest.raises(ValueError, match="must divide"):
        list(stream_video_saliency(backbone, cell, path, cfg.replace(pipeline_stages=3)))


# ---- local replicas ------------------------------------------------------------------


@pytest.fixture(scope="module")
def stage1_models():
    tree = jax_params.init_resnet_params(0, "resnet18", num_classes=16)
    return tree, jax_params.backbone_from_params(tree, "resnet18", compute_dtype=torch.float32)


def test_replicas_stage1_and_window_infer_equal_one_device(stage1_models):
    _, model = stage1_models
    rng = np.random.RandomState(2)
    frames = torch.from_numpy((rng.rand(4, 64, 128, 3) * 255).astype(np.uint8))
    reps = mesh.LocalReplicas(model, CPU2)
    assert len(reps) == 2 and reps.models[0] is reps.models[1] is model
    with torch.no_grad():
        want = extract.stage1_batch(model, frames, 32)
        got = reps.run(lambda m, f: extract.stage1_batch(m, f, 32), split=(frames,))
    assert len(got) == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    cell = _cell(jax_params.init_clstm_params(2, 8, 8))
    windows = torch.from_numpy(rng.rand(4, 5, 6, 7, 7, 8).astype(np.float32))
    creps = mesh.LocalReplicas(cell, CPU2)
    with torch.no_grad():
        assert torch.equal(creps.run(temporal.window_infer, split=(windows,)),
                           temporal.window_infer(cell, windows))
        with pytest.raises(ValueError, match=r"batch dim 3 not divisible by the mesh data "
                                             r"axis \(2 devices\)"):
            creps.run(temporal.window_infer, split=(windows[:3],))


def _feats(root, n=14, ch=8, seed=0):
    rng = np.random.RandomState(seed)
    feat = root / "v" / "cube_feat"
    feat.mkdir(parents=True)
    for t in range(2, 2 + n):
        np.save(feat / f"{t:06}.npy", rng.rand(6, ch, 7, 7).astype(np.float32))
    return str(feat)


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_infer_video_replicas_equal_one_device_and_jax(tmp_path, codec):
    feat = _feats(tmp_path)
    params = jax_params.init_clstm_params(0, 8, 8)
    cell = _cell(params)
    want = temporal.infer_video(cell, feat, 5, batch_windows=4, transfer_codec=codec)
    got = temporal.infer_video(mesh.LocalReplicas(cell, CPU2), feat, 5, batch_windows=4,
                               transfer_codec=codec)
    assert sorted(got) == sorted(want) and len(want) == 9  # a tail batch of 1 window
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if codec == "none":
        jwant = jax_temporal.infer_video(_jax(params), feat, 5, batch_windows=8,
                                         compute_dtype=jnp.float32,
                                         mesh=make_mesh(n_data=8, n_model=1))
        for k in jwant:
            np.testing.assert_allclose(got[k], jwant[k], atol=1e-5)
    with pytest.raises(ValueError, match=r"batch_windows=3 must be divisible by the mesh data "
                                         r"axis \(2 devices\) so window positions shard evenly"):
        temporal.infer_video(mesh.LocalReplicas(cell, CPU2), feat, 5, batch_windows=3)


def test_extract_frames_replicas_equal_one_device(stage1_models, tmp_path):
    _, model = stage1_models
    rng = np.random.RandomState(4)
    frames = [(rng.rand(64, 128, 3) * 255).astype(np.uint8) for _ in range(6)]
    cfg = Config(equi_h=128, equi_w=64, cube_dim=32, compute_dtype="float32", opt_flow=False,
                 extract_batch=2)
    extract.extract_frames(model, cfg, iter(frames), str(tmp_path / "one"), output_img=False)
    extract.extract_frames(mesh.LocalReplicas(model, CPU2), cfg, iter(frames),
                           str(tmp_path / "two"), output_img=False)
    names = sorted(os.listdir(tmp_path / "one" / "cube_feat"))
    assert len(names) == 5
    for f in names:
        np.testing.assert_array_equal(np.load(tmp_path / "two" / "cube_feat" / f),
                                      np.load(tmp_path / "one" / "cube_feat" / f))
    with pytest.raises(ValueError, match=r"batch_frames=3 must be divisible by the mesh data "
                                         r"axis \(2 devices\) so frames shard evenly"):
        extract.extract_frames(mesh.LocalReplicas(model, CPU2), cfg.replace(extract_batch=3),
                               iter(frames), str(tmp_path / "three"))


def test_saliency_model_mesh_data_answers_as_one_device(stage1_models):
    tree, _ = stage1_models
    clstm = jax_params.init_clstm_params(1, 16, 16)
    cfg = Config(cube_dim=32, equi_h=128, equi_w=64, input_size=16, hidden_size=16, seq_len=3,
                 compute_dtype="float32", host_cube_remap=False, serve_max_batch=3)
    one = SaliencyModel(tree, cfg, arch="resnet18", clstm_params=clstm, device="cpu")
    two = SaliencyModel(tree, cfg.replace(mesh_data=2), arch="resnet18", clstm_params=clstm,
                        device="cpu", devices=CPU2)
    try:
        # the cap of 3 rounds down to a multiple of the data axis, buckets up to one
        assert two._batcher.max_batch == 2 and two._bucket(1, 2) == 2
        assert one.data_parallel == 1 and two.data_parallel == 2
        rng = np.random.RandomState(6)
        frames = [(rng.rand(64, 128, 3) * 255).astype(np.uint8) for _ in range(4)]
        for f in frames[:2]:
            np.testing.assert_array_equal(two.predict(f), one.predict(f))
        sids = [m.temporal_start() for m in (one, two)]
        for f in frames:
            (i1, s1), (i2, s2) = (m.temporal_push(s, f) for m, s in zip((one, two), sids))
            assert i1 == i2
            if s1 is None:
                assert s2 is None
            else:
                np.testing.assert_array_equal(s2, s1)
        assert "cp360_data_parallel 2" in two.request_metrics.render(two)
    finally:
        one.close()
        two.close()
    with pytest.raises(ValueError, match="needs 2 devices, got 3"):
        SaliencyModel(tree, cfg.replace(mesh_data=2), arch="resnet18", device="cpu",
                      devices=["cpu"] * 3)


def test_replica_and_stage_devices_must_exist():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cell = _cell(jax_params.init_clstm_params(0, 8, 8))
    with pytest.raises(ValueError, match=r"names cuda:0, only 0 device\(s\) available"):
        mesh.LocalReplicas(cell, ["cuda:0"])
    with pytest.raises(ValueError, match=r"mesh 2x1 needs 2 devices, only 0 available"):
        mesh.local_devices("cuda", 2)
    assert mesh.local_devices("cpu", 3) == [torch.device("cpu")] * 3


# ---- gating, rows, shards -------------------------------------------------------------


def test_maybe_init_distributed_gated_off(monkeypatch):
    monkeypatch.delenv("CP360_DIST", raising=False)
    assert mesh.maybe_init_distributed("cpu") is False
    monkeypatch.setenv("CP360_DIST", "0")
    assert mesh.maybe_init_distributed("cpu") is False
    assert mesh.process_count() == 1 and mesh.process_index() == 0
    assert mesh.stripe_jobs(["a", "b", "c"]) == ["a", "b", "c"]


def test_partial_rendezvous_env_raises_jax_words():
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from cp360_tpu_torch.parallel.mesh import maybe_init_distributed
        maybe_init_distributed("cpu")
    """)
    env = dict(os.environ, CP360_DIST="1", CP360_NUM_PROCESSES="2")
    env.pop("CP360_COORDINATOR", None)
    env.pop("CP360_PROCESS_ID", None)
    p = subprocess.run([sys.executable, "-c", code, REPO], env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 1
    assert ("CP360_DIST explicit rendezvous needs ALL of CP360_COORDINATOR, "
            "CP360_NUM_PROCESSES and CP360_PROCESS_ID") in p.stderr


def test_stripes_rows_and_shards_follow_the_jax_layout(monkeypatch):
    monkeypatch.setattr(mesh, "process_count", lambda: 3)
    monkeypatch.setattr(mesh, "process_index", lambda: 1)
    assert mesh.stripe_jobs(list(range(8))) == [1, 4, 7]

    class Grid:  # rank 5 of a 4x2 grid: data index 2, model index 1
        n_data, n_model, data_index, model_index = 4, 2, 2, 1

    assert mesh.local_rows_slice(Grid, 8) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible by the mesh data axis"):
        mesh.local_rows_slice(Grid, 6)
    seq = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(mesh.shard_batch(Grid, seq), seq[4:6])
    rows = seq[4:6]
    assert mesh.shard_batch_per_host(Grid, rows) is rows
    params = jax_params.init_clstm_params(0, 8, 8)
    shard = mesh.shard_clstm_params(params, 2, 1)
    for name in params:
        cout = params[name]["w"].shape[-1]
        np.testing.assert_array_equal(shard[name]["w"], params[name]["w"][..., cout // 2:])
        np.testing.assert_array_equal(shard[name]["b"], params[name]["b"][cout // 2:])


def test_one_process_refuses_a_training_mesh_naming_the_launcher(tmp_path):
    from cp360_tpu_torch.cli import train_temporal

    for argv in (["--data-parallel", "2"], ["--set", "mesh_model=2"]):
        with pytest.raises(ValueError, match=r"needs 2 ranks \(one per card\).*"
                                             r"cli\.launch --nprocs 2"):
            train_temporal.main(["--input", str(tmp_path), "--device", "cpu"] + argv)


def test_supervise_refuses_one_worker_of_a_multiprocess_job(monkeypatch, tmp_path):
    from cp360_tpu_torch.cli import extract_features, test_temporal, train_temporal

    monkeypatch.setenv("CP360_DIST", "1")
    monkeypatch.setenv("CP360_NUM_PROCESSES", "2")
    monkeypatch.setenv("CP360_PROCESS_ID", "0")
    monkeypatch.chdir(tmp_path)
    for main, argv in ((train_temporal.main, ["--input", str(tmp_path)]),
                       (test_temporal.main, ["--model", "m.npz", "--dir", str(tmp_path)]),
                       (extract_features.main, [])):
        with pytest.raises(SystemExit, match="whole launch"):
            main(argv + ["--supervise", "--device", "cpu"])


# ---- concurrent kernel builds -------------------------------------------------------


FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(f"{{os.getpid()}}\\n")
with open(out, "wb") as f:  # a slow, chunked write: a torn file would be short
    for _ in range(20):
        f.write(b"x" * 4096)
        f.flush()
        time.sleep(0.05)
"""

BUILDER = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from cp360_tpu_torch.ops import _build
_build.CSRC = _build.BUILD_DIR = Path(sys.argv[2])
print("BUILT", sorted(_build.build(("fake",))))
"""


def test_two_processes_building_one_source_leave_one_intact_library(tmp_path):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    (tmp_path / "fake.cu").write_text("// stand-in source\n")
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}",
               FAKE_NVCC_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, REPO, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(o.strip().splitlines()[-1] for o in outs) == ["BUILT ['fake']", "BUILT []"]
    assert len(log.read_text().split()) == 1  # one compiler run
    libs = list(tmp_path.glob("fake-*.so"))
    assert len(libs) == 1 and libs[0].stat().st_size == 20 * 4096
    assert not list(tmp_path.glob("*.tmp"))
