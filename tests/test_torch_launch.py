"""PyTorch port, multi-process runs: the launcher and two gloo ranks on the CPU.

The port's forms of tests/test_launch.py and tests/test_distributed.py.
Each rank is a real OS process joining the job through
``parallel/mesh.py::maybe_init_distributed`` (gloo on the CPU); every
subprocess has its own timeout and is killed on the way out, and ports come
from ``bind(0)``.  Widths are cut for the CPU (ConvLSTM 8 or 16 channels).

Tolerances: the dp 2x1 and tp 1x2 train steps against JAX's one-device
step on the same params and batch, as tests/test_parallel.py holds its
dp/tp step: losses at rel 1e-5, the dp update lr * g at atol 1e-6 (SGD at
lr 1e-3), the tp update by cosine > 0.999 (the channel max routes
subgradients differently under reassociation); the two-rank train CLI
within 1e-4 of one process (npz); the two-rank test_temporal aggregate as
tests/test_distributed.py holds JAX's (CC 1e-5, AUC 1e-3, AUC-Borji 0.05,
which resamples its fixations per run).
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.train import loop as jax_loop
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.data.dataset import builtin_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **extra)
    for key in ("CP360_DIST", "CP360_COORDINATOR", "CP360_NUM_PROCESSES", "CP360_PROCESS_ID",
                "CP360_DIST_BACKEND"):
        if key not in extra:
            env.pop(key, None)
    return env


def _ranks(argv, n, cwd=REPO, timeout=TIMEOUT_S):
    """Run ``argv`` as ranks 0..n-1 of one job (n = 1: a plain process);
    returns [(returncode, output)]."""
    port = _free_port()
    procs = []
    for pid in range(n):
        dist = dict(CP360_DIST="1", CP360_COORDINATOR=f"127.0.0.1:{port}",
                    CP360_NUM_PROCESSES=str(n), CP360_PROCESS_ID=str(pid)) if n > 1 else {}
        procs.append(subprocess.Popen(argv, env=_env(**dist), cwd=cwd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def _launch(extra, cmd, timeout=TIMEOUT_S):
    """The launcher as a subprocess; on a timeout it gets SIGINT first (it
    then takes its workers down), SIGKILL after."""
    p = subprocess.Popen([sys.executable, "-m", "cp360_tpu_torch.cli.launch", *extra, "--",
                          *cmd], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.send_signal(signal.SIGINT)
        try:
            out, err = p.communicate(timeout=45)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        raise AssertionError(f"launcher timed out:\n{out}\n{err}")
    return p.returncode, out, err


# ---- the launcher ------------------------------------------------------------------


def test_launch_runs_two_distributed_workers():
    rc, out, err = _launch(["--nprocs", "2"], [sys.executable, WORKER, "hello"])
    assert rc == 0, out + err
    assert "[p0] DIST_OK pid=0 n=2 sum=3" in out, out
    assert "[p1] DIST_OK pid=1 n=2 sum=3" in out, out
    assert "[p0] torch.distributed initialized: process 0/2, backend gloo, device cpu" in out


def test_launch_failure_takes_down_survivors():
    code = ("import os, sys, time\n"
            "if os.environ['CP360_PROCESS_ID'] == '1':\n"
            "    sys.exit(2)\n"
            "time.sleep(600)\n")
    t0 = time.time()
    rc, out, err = _launch(["--nprocs", "2"], [sys.executable, "-c", code], timeout=120)
    assert rc == 1, out + err
    assert time.time() - t0 < 60, "survivors were not terminated"
    assert "worker failure" in err


def test_launch_refuses_bad_usage():
    rc, _, err = _launch(["--nprocs", "2"], [])
    assert rc == 2 and "no worker command" in err
    rc, _, err = _launch(["--nprocs", "2", "--devices-per-proc", "4"], [sys.executable, "-V"])
    assert rc == 2 and "CP360_DIST_BACKEND=gloo" in err


# ---- one train step on a grid of two ranks -----------------------------------------


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """Params, a batch of 8 windows and JAX's one-device SGD step on them."""
    ch = 16
    root = tmp_path_factory.mktemp("step")
    params = jax_params.init_clstm_params(0, ch, ch)
    rng = np.random.RandomState(1)
    seq = rng.rand(8, 5, 6, 7, 7, ch).astype(np.float32)
    flows = rng.randn(8, 5, 16, 32, 2).astype(np.float32)
    np.savez(root / "in.npz", ch=ch, flow_h=16, seq=seq, flows=flows,
             **{f"{n}/{k}": params[n][k] for n in params for k in ("w", "b")})
    cfg = JaxConfig(input_size=ch, hidden_size=ch, flow_h=16, lr=1e-3, compute_dtype="float32")
    opt = optax.sgd(cfg.lr)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp1, _, jm = jax_loop.make_train_step(cfg, opt)(jp, opt.init(jp), jnp.asarray(seq),
                                                    jnp.asarray(flows))
    update = {f"{n}/{k}": params[n][k] - np.asarray(jp1[n][k]) for n in params for k in ("w", "b")}
    return root, cfg.lr, {k: float(v) for k, v in jm.items()}, update


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2)])
def test_two_rank_train_step_equals_jax_one_device_step(step_case, tmp_path, n_data, n_model):
    root, lr, jm, update = step_case
    res = _ranks([sys.executable, WORKER, "step", str(root / "in.npz"), str(tmp_path),
                  str(n_data), str(n_model)], 2)
    for pid, (rc, out) in enumerate(res):
        assert rc == 0 and f"STEP_OK pid={pid}" in out, out
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in ranks:
        for k in ("loss", "smooth", "temporal", "mask"):
            assert abs(float(r[k]) - jm[k]) <= 1e-5 * abs(jm[k]), (k, float(r[k]), jm[k])
    assert ranks[0]["loss"] == ranks[1]["loss"]
    for key, want in update.items():
        got = [lr * r[f"grad/{key}"] for r in ranks]
        np.testing.assert_array_equal(got[0], got[1])  # every rank holds the one update
        if n_model == 1:
            np.testing.assert_allclose(got[0], want, atol=1e-6, err_msg=key)
        else:
            cos = (got[0].ravel() @ want.ravel()
                   / (np.linalg.norm(got[0]) * np.linalg.norm(want)))
            assert cos > 0.999, (key, cos)


# ---- the train CLI on two ranks ------------------------------------------------------


def _train_artifacts(root, ch=8, n_frames=12):
    rng = np.random.RandomState(0)
    for vid in builtin_split("train_60")[:2]:
        fd, md = root / vid / "cube_feat", root / vid / "motion"
        fd.mkdir(parents=True)
        md.mkdir(parents=True)
        for t in range(2, n_frames + 1):
            np.save(fd / f"{t:06}.npy", rng.rand(6, ch, 7, 7).astype(np.float32))
            np.save(md / f"{t:06}.npy", rng.randn(16, 32, 2).astype(np.float32))


def _loss_lines(out):
    return [ln.split("loss_avg=")[1].split()[0] for ln in out.splitlines() if "loss_avg=" in ln]


@pytest.mark.parametrize("backend,mesh,spans", [
    ("npz", ["--data-parallel", "2"], ["[0:4)", "[4:8)"]),
    ("orbax", ["--set", "mesh_model=2"], ["[0:8)", "[0:8)"]),
])
def test_two_rank_train_cli(tmp_path, backend, mesh, spans):
    """The training CLI over two ranks: the same global loss on both, each
    rank reading its rows, one writer of the metrics and the npz files; the
    orbax (DCP) backend writes each rank's slices and resumes from them."""
    arts = tmp_path / "static"
    _train_artifacts(arts)

    def argv(ck, epochs=1, *extra):
        cmd = [sys.executable, "-m", "cp360_tpu_torch.cli.train_temporal", "--input", str(arts),
               "--device", "cpu", "--metrics-jsonl", str(tmp_path / f"{ck}.jsonl")]
        for s in (f"checkpoint_path={tmp_path / ck}", "input_size=8", "hidden_size=8",
                  "flow_h=16", "batch_size=8", f"epochs={epochs}", "save_freq=1",
                  "summary_freq=1", "compute_dtype=float32", "processes=2",
                  f"checkpoint_backend={backend}"):
            cmd += ["--set", s]
        return cmd + list(extra)

    res = _ranks(argv("ck") + mesh, 2)
    for pid, (rc, out) in enumerate(res):
        assert rc == 0, f"rank {pid} failed:\n{out}"
    l0, l1 = (_loss_lines(out) for _, out in res)
    assert l0 and l0 == l1, (l0, l1)
    got_spans = sorted(ln.split("rows ")[1].split(" of")[0] for _, out in res
                       for ln in out.splitlines() if "per-host feeding" in ln)
    assert got_spans == spans, got_spans
    with open(tmp_path / "ck.jsonl") as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert sum(r["event"] == "train" for r in recs) == len(l0)  # one writer
    assert glob.glob(str(tmp_path / "ck" / "*" / "epoch_00.npz"))
    if backend == "npz":
        (rc, out), = _ranks(argv("ck1"), 1)
        assert rc == 0, out
        ref = _loss_lines(out)
        assert len(ref) == len(l0)
        for a, b in zip(ref, l0):
            assert abs(float(a) - float(b)) <= 1e-4 * max(1.0, abs(float(a))), (ref, l0)
        state = glob.glob(str(tmp_path / "ck" / "*" / "train_state_latest.npz"))
        assert len(state) == 1
        with np.load(state[0]) as f:
            assert int(f["step"]) >= 1 and f["params/5"].shape == (3, 3, 32, 32)  # gates/w, whole
    else:
        steps = glob.glob(str(tmp_path / "ck" / "*" / "orbax" / "*" / ".metadata"))
        assert steps, "no DCP checkpoint written"
        res = _ranks(argv("ck", 2, "--resume") + mesh, 2)
        for pid, (rc, out) in enumerate(res):
            assert rc == 0, f"rank {pid} failed on resume:\n{out}"
            assert "resumed full train state" in out and "resume: " not in out.split(
                "resumed full train state")[0]
        l0r, l1r = (_loss_lines(out) for _, out in res)
        assert l0r and l0r == l1r and len(l0r) == len(l0)  # epoch 1 alone ran


# ---- test_temporal over two ranks ----------------------------------------------------


def _test_artifacts(tmp_path, corrupt=False, ch=8, n_frames=12):
    vids = builtin_split("test_25")[:2]
    arts, labels = tmp_path / "static", tmp_path / "labels"
    rng = np.random.RandomState(0)
    for vid in vids:
        fd, gd = arts / vid / "cube_feat", labels / f"{vid}.mp4"
        fd.mkdir(parents=True)
        gd.mkdir(parents=True)
        for t in range(2, n_frames + 1):
            np.save(fd / f"{t:06}.npy", rng.rand(6, ch, 7, 7).astype(np.float32))
            gt = rng.rand(120, 240).astype(np.float32) * 0.1  # peaked: fixations exist
            gt.ravel()[rng.randint(0, gt.size, size=40)] += 1.0
            np.save(gd / f"{t:05}.npy", gt)
    if corrupt:  # rank 1's stripe (vids[1] under [pid::n] striping)
        (arts / vids[1] / "cube_feat" / "000004.npy").write_bytes(b"not an npy")
    jax_params.save_npz(str(tmp_path / "clstm.npz"), jax_params.init_clstm_params(0, ch, ch))
    return vids, arts, labels


def _temporal_argv(tmp_path, arts, labels, out):
    return [sys.executable, "-m", "cp360_tpu_torch.cli.test_temporal",
            "--config", os.path.join(REPO, "config.yaml"), "--model",
            str(tmp_path / "clstm.npz"), "--dir", str(arts), "--batch-windows", "8",
            "--device", "cpu", "--set", f"output_path={out}", "--set",
            f"label_path={labels}", "--set", "input_size=8", "--set", "hidden_size=8",
            "--set", "compute_dtype=float32"]


def _result(cwd):
    with open(os.path.join(cwd, "static_result.txt")) as f:
        return tuple(map(float, f.read().split(":")[1].split(",")))


def test_two_rank_test_temporal_stripes_and_merges(tmp_path):
    vids, arts, labels = _test_artifacts(tmp_path)
    runs = {}
    for n in (1, 2):
        cwd = tmp_path / f"run{n}"
        cwd.mkdir()
        res = _ranks(_temporal_argv(tmp_path, arts, labels, cwd), n, cwd=str(cwd))
        for pid, (rc, out) in enumerate(res):
            assert rc == 0, f"rank {pid} of {n} failed:\n{out}"
        runs[n] = (_result(str(cwd)), [out for _, out in res])
    (cc1, auc1, aucb1), _ = runs[1]
    (cc2, auc2, aucb2), outs = runs[2]
    assert sum("takes 1 video(s)" in o for o in outs) == 2
    assert sum("==========" in o for o in outs) == 1  # rank 0 alone aggregates
    for vid in vids:
        assert (tmp_path / "run2" / "temporal" / vid).is_dir()
    assert not list((tmp_path / "run2" / "temporal").glob("_partial_*"))
    assert abs(cc2 - cc1) < 1e-5, (cc1, cc2)
    assert abs(auc2 - auc1) < 1e-3, (auc1, auc2)
    assert abs(aucb2 - aucb1) < 0.05, (aucb1, aucb2)


def test_two_rank_test_temporal_failed_stripe_fails_fast(tmp_path):
    _, arts, labels = _test_artifacts(tmp_path, corrupt=True)
    t0 = time.time()
    (rc0, out0), (rc1, out1) = _ranks(_temporal_argv(tmp_path, arts, labels, tmp_path), 2,
                                      cwd=str(tmp_path), timeout=180)
    assert time.time() - t0 < 150
    assert rc1 != 0, out1  # the corrupted stripe
    assert rc0 != 0, out0  # refuses a partial aggregate
    assert "stripe(s) on process(es) [1] failed" in out0, out0[-800:]
    assert not list((tmp_path / "temporal").glob("_partial_*")), "partials leaked"
