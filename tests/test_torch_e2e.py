"""PyTorch port, end to end against the reference pipeline's golden run.

``tests/golden/e2e/`` holds two synthetic videos and what the reference
drivers (static_model/dataset_feat_extractor.py ->
temporal_model/test_temporal.py -> metrics) made of them at 224x448 frames,
100 classes and a 100/100 ConvLSTM.  The same videos and weights go
through the port's CLIs on the CPU (``--device cpu``), at the tolerances of
``tests/test_e2e_golden.py``:

  1. stage-1 artifacts from the mp4s: same names, relative error < 0.02
     (the reference's cv2.remap samples at 1/32 pixel, the port exactly);
  2. stage 2 + metrics from the reference's own artifacts: predictions to
     atol 2e-5 / rtol 1e-4, aggregate to 1e-4;
  3. the full chain from the mp4s: aggregate to 5e-3;

plus ``--resume``: a finished video is skipped and its cached metrics keep
the aggregate.  The weights are made with the JAX package's converters and
read by the port from ``.npz``.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from test_e2e_golden import (
    CONFIG_TMPL,
    GOLD_DIR,
    GOLDEN,
    SEED,
    SEQ_LEN,
    VIDS,
    golden_group,
    parse_result_txt,
    rebuild_state_dict,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def sandbox(tmp_path_factory):
    """Videos, GT, reference artifacts, weights, and the port's stage-1
    CLI output."""
    from cp360_tpu.compat.torch_weights import (
        convert_clstm_state_dict,
        convert_resnet_state_dict,
        save_npz,
    )
    from cp360_tpu_torch.cli import extract_features

    root = tmp_path_factory.mktemp("torch_e2e")
    (root / "dataset" / "test").mkdir(parents=True)
    (root / "output").mkdir()
    for vid in VIDS:
        shutil.copy(os.path.join(GOLD_DIR, vid + ".mp4"),
                    root / "dataset" / "test" / (vid + ".mp4"))
        gtd = root / "Wild360_GT" / (vid + ".mp4")
        gtd.mkdir(parents=True)
        for fidx, gt in golden_group("gt", vid).items():
            np.save(gtd / f"{fidx}.npy", gt)
        rdir = root / "ref_arts" / vid / "cube_feat"
        rdir.mkdir(parents=True)
        for cnt, feat in golden_group("feat", vid).items():
            np.save(rdir / f"{cnt}.npy", feat)
    (root / "config.yaml").write_text(CONFIG_TMPL.format(root=root, seq=SEQ_LEN))
    save_npz(str(root / "resnet50.npz"),
             convert_resnet_state_dict(rebuild_state_dict("resnet"), "resnet50"))
    save_npz(str(root / "clstm.npz"), convert_clstm_state_dict(rebuild_state_dict("clstm")))

    cwd = os.getcwd()
    os.chdir(root)
    try:
        extract_features.main(["--out", "static", "--mode", "resnet50", "-of",
                               "--weights", str(root / "resnet50.npz"),
                               "--config", str(root / "config.yaml"), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return root


def run_temporal(root, artifact_dir, *extra):
    from cp360_tpu_torch.cli import test_temporal

    cwd = os.getcwd()
    os.chdir(root)
    np.random.seed(SEED)
    try:
        agg = test_temporal.main(["--model", str(root / "clstm.npz"), "--dir", str(artifact_dir),
                                  "--batch-windows", "8", "--config", str(root / "config.yaml"),
                                  "--device", "cpu", *extra])
        with open(f"{str(artifact_dir).split('/')[-1]}_result.txt") as f:
            result = parse_result_txt(f.read())
    finally:
        os.chdir(cwd)
    return result, agg


def test_port_stage1_artifacts_match_golden(sandbox):
    for vid in VIDS:
        ours_dir = sandbox / "output" / "static_resnet50" / vid / "cube_feat"
        want = golden_group("feat", vid)
        assert sorted(p[:-4] for p in os.listdir(ours_dir)) == sorted(want)
        worst = 0.0
        for cnt, ref in want.items():
            ours = np.load(ours_dir / f"{cnt}.npy")
            assert ours.shape == ref.shape and ours.dtype == np.float32
            worst = max(worst, np.abs(ours - ref).max() / np.abs(ref).max())
        assert worst < 0.02, f"{vid}: relative CAM artifact error {worst}"


def test_port_stage2_composition_exact(sandbox):
    result, _ = run_temporal(sandbox, sandbox / "ref_arts")
    for vid in VIDS:
        want = golden_group("pred", vid)
        out_dir = sandbox / "output" / "temporal" / vid
        assert sorted(p[:-4] for p in os.listdir(out_dir) if p.endswith(".npy")) == sorted(want)
        for fidx, ref in want.items():
            np.testing.assert_allclose(np.load(out_dir / f"{fidx}.npy"), ref,
                                       atol=2e-5, rtol=1e-4)
    want = parse_result_txt(str(GOLDEN["result_txt"]))
    np.testing.assert_allclose(result, want, rtol=0, atol=1e-4)


def test_port_full_chain_metrics(sandbox):
    result, _ = run_temporal(sandbox, sandbox / "output" / "static_resnet50")
    want = parse_result_txt(str(GOLDEN["result_txt"]))
    np.testing.assert_allclose(result, want, rtol=0, atol=5e-3)


def test_port_resume_skips_finished_videos(sandbox, tmp_path):
    """A second run with --resume recomputes nothing and gives the same
    aggregate from the markers; dropping the first video's marker
    recomputes that video only (first, so it draws the same metric RNG
    stream as before)."""
    from cp360_tpu_torch.data.dataset import builtin_split

    first_vid = [v for v in builtin_split("test_25") if v in VIDS][0]
    out = tmp_path / "out"
    extra = ["--set", f"output_path={out}"]
    first, agg1 = run_temporal(sandbox, sandbox / "ref_arts", *extra)
    files = {p: p.stat().st_mtime_ns for p in out.rglob("*.npy")}
    assert len(files) == sum(len(golden_group("pred", v)) for v in VIDS)
    second, agg2 = run_temporal(sandbox, sandbox / "ref_arts", "--resume", *extra)
    assert second == first and agg2 == agg1
    assert {p: p.stat().st_mtime_ns for p in out.rglob("*.npy")} == files
    os.remove(out / "temporal" / first_vid / "_done.npz")
    third, _ = run_temporal(sandbox, sandbox / "ref_arts", "--resume", *extra)
    np.testing.assert_allclose(third, first, rtol=0, atol=1e-12)
    redone = [p for p in out.rglob("*.npy") if p.stat().st_mtime_ns != files[p]]
    assert redone and all(p.parent.name == first_vid for p in redone)


@pytest.mark.parametrize("prefix", ["resnet", "clstm"])
def test_port_converters_equal_jax(prefix):
    """The port's state-dict converters (which the chip smoke uses to build
    the goldens' weights without JAX) give the JAX package's trees."""
    from cp360_tpu.compat import torch_weights
    from cp360_tpu_torch.compat import jax_params

    sd = rebuild_state_dict(prefix)
    if prefix == "resnet":
        got = jax_params.convert_resnet_state_dict(sd, "resnet50")
        want = torch_weights.convert_resnet_state_dict(sd, "resnet50")
    else:
        got = jax_params.convert_clstm_state_dict(sd)
        want = torch_weights.convert_clstm_state_dict(sd)
    got, want = jax_params.flatten_params(got), jax_params.flatten_params(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].flags.c_contiguous or got[k].ndim < 2
        np.testing.assert_array_equal(got[k], want[k])
