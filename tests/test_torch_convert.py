"""PyTorch port, ``.pth`` weights: compat/torch_weights.py and
cli/convert_weights.py against the JAX package's, and every CLI reading a
``.pth`` backbone or ConvLSTM, on the CPU.

The converters move arrays without arithmetic, so every comparison here is
bit for bit: the port's exports and imports against the JAX package's,
export∘convert as the identity, the convert CLI's files against JAX's
(the vgg16 head excepted: the port fills it from its own seeded numpy
init, the JAX CLI from ``jax.random``), its exit codes and messages as in
tests/test_compat.py:76-145,241-280, and each CLI's outputs with ``.pth``
weights equal to the same run with the ``.npz`` they were exported from.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from test_torch_backbones import mobilenet_v2_state_dict, resnet_state_dict, vgg16_bn_state_dict

from cp360_tpu.cli import convert_weights as jax_cli
from cp360_tpu.compat import torch_weights as jtw
from cp360_tpu_torch.cli import convert_weights as cli
from cp360_tpu_torch.compat import jax_params as jp
from cp360_tpu_torch.compat import torch_weights as tw
from cp360_tpu_torch.data.dataset import builtin_split

torch.set_num_threads(2)


def _equal(a, b):
    fa, fb = jp.flatten_params(a), jp.flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg=k)


def _save_pth(path, sd):
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, str(path))
    return str(path)


def clstm_state_dict(seed=0, cin=6, hidden=4):
    rs = np.random.RandomState(seed)
    h4 = 4 * hidden
    return {"Conv1.weight": rs.randn(h4, cin + hidden, 3, 3).astype(np.float32),
            "Conv1.bias": rs.randn(h4).astype(np.float32),
            "Conv2.weight": rs.randn(h4, h4, 3, 3).astype(np.float32),
            "Conv2.bias": rs.randn(h4).astype(np.float32),
            "Gates.weight": rs.randn(h4, h4, 3, 3).astype(np.float32),
            "Gates.bias": rs.randn(h4).astype(np.float32)}


# ---- the library --------------------------------------------------------------------


def test_load_torch_state_dict_takes_a_dict_or_a_module(tmp_path):
    mod = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4))
    torch.save(mod, str(tmp_path / "m.pth"))
    torch.save(mod.state_dict(), str(tmp_path / "sd.pth"))
    for name in ("m.pth", "sd.pth"):
        got = tw.load_torch_state_dict(str(tmp_path / name))
        want = jtw.load_torch_state_dict(str(tmp_path / name))
        assert sorted(got) == sorted(want) and "1.running_var" in got
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_merge_pretrained_tolerant_equals_jax():
    init = jp.init_resnet_params(0, "resnet18", num_classes=10)
    conv = jp.convert_resnet_state_dict(resnet_state_dict("resnet18", 1, 1000), "resnet18")
    conv["extra"] = {"w": np.zeros(3, np.float32)}
    logs, jlogs = [], []
    got = tw.merge_pretrained_tolerant(init, conv, log_fn=logs.append)
    want = jtw.merge_pretrained_tolerant(init, conv, log_fn=jlogs.append)
    _equal(got, want)
    assert logs == jlogs and any("fc/w" in m and "inconsistent size" in m for m in logs)
    assert any("unexpected key 'extra/w'" in m for m in logs)
    np.testing.assert_array_equal(got["fc"]["w"], init["fc"]["w"])  # 1000 vs 10 classes
    np.testing.assert_array_equal(got["conv1"]["w"], conv["conv1"]["w"])


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50", "resnet101",
                                  "resnet152"])
def test_resnet_export_is_the_inverse_of_convert(arch):
    tree = jp.init_resnet_params(2, arch, num_classes=10)
    sd = tw.export_resnet_state_dict(tree, arch)
    want = jtw.export_resnet_state_dict(tree, arch)
    assert sorted(sd) == sorted(want)
    for k in sd:
        np.testing.assert_array_equal(sd[k], want[k], err_msg=k)
        assert sd[k].dtype == want[k].dtype
    _equal(jp.convert_resnet_state_dict(sd, arch), tree)
    with pytest.raises(ValueError, match="blocks"):
        tw.export_resnet_state_dict({**tree, "layer1": tree["layer1"][:1]}, arch)


def test_clstm_export_and_the_one_shot_files(tmp_path):
    tree = jp.init_clstm_params(3, 6, 10)
    sd = tw.export_clstm_state_dict(tree)
    assert sorted(sd) == sorted(jtw.export_clstm_state_dict(tree))
    _equal(jp.convert_clstm_state_dict(sd), tree)
    jp.save_npz(str(tmp_path / "c.npz"), tree)
    assert tw.export_pth(str(tmp_path / "c.npz"), str(tmp_path / "c.pth")) == ("clstm", 6)
    assert tw.convert_pth(str(tmp_path / "c.pth"), str(tmp_path / "back.npz"),
                          "clstm") == ("clstm", 6)
    _equal(jp.load_npz(str(tmp_path / "back.npz")), tree)
    jtw.convert_pth(str(tmp_path / "c.pth"), str(tmp_path / "jax.npz"), "clstm")
    _equal(jp.load_npz(str(tmp_path / "jax.npz")), tree)
    for fn in (tw.convert_pth, tw.export_pth):
        with pytest.raises(ValueError, match="unknown kind"):
            fn(str(tmp_path / "c.pth"), str(tmp_path / "x.npz"), "nope")


# ---- the convert CLI ----------------------------------------------------------------


SNIFF_CASES = [
    list(clstm_state_dict()),
    list(resnet_state_dict("resnet18", 0, 10)),
    list(vgg16_bn_state_dict(0)) + ["classifier.0.weight"],
    list(mobilenet_v2_state_dict(0)),
    ["a", "b", "c", "d", "e", "f"],  # six unnamed tensors: the sequential ConvLSTM
    ["weight", "bias"],
]


@pytest.mark.parametrize("keys", SNIFF_CASES)
def test_sniff_kind_equals_jax(keys):
    assert tw.sniff_kind(keys) == jax_cli.sniff_kind(keys)


def test_sniff_kind_npz_equals_jax():
    for tree in (jp.init_clstm_params(0, 2, 2), jp.init_resnet_params(0, "resnet18", 2),
                 jp.init_vgg16_params(0, 2), jp.init_mobilenet_v2_params(0, 2)):
        keys = list(jp.flatten_params(tree))
        assert tw.sniff_kind_npz(keys) == jax_cli.sniff_kind_npz(keys)
    assert [tw.sniff_kind_npz(jp.flatten_params(t)) for t in (
        jp.init_clstm_params(0, 2, 2), jp.init_vgg16_params(0, 2),
        jp.init_mobilenet_v2_params(0, 2))] == ["clstm", "vgg16", "mobilenet_v2"]


@pytest.mark.parametrize("kind", ["clstm", "resnet", "vgg16", "mobilenet_v2"])
def test_cli_imports_each_sniffed_kind_as_jax_does(kind, tmp_path, capsys):
    sd = {"clstm": clstm_state_dict, "resnet": lambda: resnet_state_dict("resnet34", 0, 10),
          "vgg16": lambda: {**vgg16_bn_state_dict(0),
                            "classifier.0.weight": np.zeros((2, 2), np.float32)},
          "mobilenet_v2": lambda: mobilenet_v2_state_dict(0)}[kind]()
    pth = _save_pth(tmp_path / "in.pth", sd)
    extra = ["--arch", "resnet34"] if kind == "resnet" else []
    assert cli.main([pth, str(tmp_path / "port.npz"), *extra]) == 0
    assert f"sniffed kind={kind}" in capsys.readouterr().err
    got = jp.load_npz(str(tmp_path / "port.npz"))
    assert jax_cli.main([pth, str(tmp_path / "jax.npz"), *extra]) == 0
    want = jp.load_npz(str(tmp_path / "jax.npz"))
    if kind == "vgg16":  # the head: the port's seeded numpy init
        _equal(got["features"], want["features"])
        _equal({k: got[k] for k in ("camconv", "classifier")},
               {k: jp.init_vgg16_params(0)[k] for k in ("camconv", "classifier")})
    else:
        _equal(got, want)


@pytest.mark.parametrize("arch", ["resnet18", "resnet101"])
def test_cli_export_then_import_is_the_identity(arch, tmp_path):
    tree = jp.init_resnet_params(4, arch, num_classes=10)
    npz = str(tmp_path / "w.npz")
    jp.save_npz(npz, tree)
    pth = str(tmp_path / "w.pth")
    assert cli.main([npz, pth, "--arch", arch]) == 0
    loaded = torch.load(pth, map_location="cpu", weights_only=True)
    want = jtw.export_resnet_state_dict(tree, arch)
    assert sorted(loaded) == sorted(want)
    assert cli.main([pth, str(tmp_path / "back.npz"), "--kind", "resnet", "--arch", arch]) == 0
    _equal(jp.load_npz(str(tmp_path / "back.npz")), tree)


def _exit2_cases(tmp_path):
    npz = str(tmp_path / "c.npz")
    jp.save_npz(npz, jp.init_clstm_params(0, 2, 2))
    vgg, mob = str(tmp_path / "v.npz"), str(tmp_path / "m.npz")
    jp.save_npz(vgg, jp.init_vgg16_params(0, 2))
    jp.save_npz(mob, jp.init_mobilenet_v2_params(0, 2))
    pth = _save_pth(tmp_path / "c.pth", clstm_state_dict())
    return {
        "npz_to_npz": ([npz, str(tmp_path / "x.npz")], "both files are .npz"),
        "pth_to_pth": ([pth, str(tmp_path / "out.pth")], "name it *.npz"),
        "missing_pth": ([str(tmp_path / "none.pth"), str(tmp_path / "x.npz")],
                        "no such file"),
        "missing_npz": ([str(tmp_path / "none.npz"), str(tmp_path / "x.pth")],
                        "no such file"),
        "export_vgg16": ([vgg, str(tmp_path / "v.pth")], "not supported for vgg16"),
        "export_mobilenet": ([mob, str(tmp_path / "m.pth")],
                             "not supported for mobilenet_v2"),
        "pth_not_a_resnet": ([pth, str(tmp_path / "x.npz"), "--kind", "resnet"],
                             "does not look like a resnet"),
        "npz_not_a_resnet": ([npz, str(tmp_path / "x.pth"), "--kind", "resnet"],
                             "does not look like a resnet params tree"),
    }


@pytest.mark.parametrize("case", ["npz_to_npz", "pth_to_pth", "missing_pth", "missing_npz",
                                  "export_vgg16", "export_mobilenet", "pth_not_a_resnet",
                                  "npz_not_a_resnet"])
def test_cli_usage_errors_exit_2_as_jax(case, tmp_path, capsys):
    argv, msg = _exit2_cases(tmp_path)[case]
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert msg in err and "Traceback" not in err
    assert jax_cli.main(argv) == 2
    assert msg in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x.npz") and not os.path.exists(tmp_path / "out.pth")


# ---- every CLI with .pth weights ----------------------------------------------------


CLASSES = 16
CONFIG = """\
data_vid_path: {root}/dataset
label_path: {root}/gt
output_path: {out}
checkpoint_path: {root}/checkpoint
test_mode: true
train_mode: false
opt_flow: false
equi_h: 128
equi_w: 64
cube_dim: 64
seq_len: 3
input_size: {classes}
hidden_size: {classes}
compute_dtype: float32
feat_dtype: float16
extract_batch: 4
"""


@pytest.fixture(scope="module")
def sandbox(tmp_path_factory):
    """A seeded 7-frame test_25 video, GT, configs writing to two output
    roots, and each family's weights as .npz and as the .pth they export
    to (vgg16 and mobilenet_v2 from torchvision-layout state dicts)."""
    root = tmp_path_factory.mktemp("pth_clis")
    vid = builtin_split("test_25")[0]
    (root / "dataset" / "test").mkdir(parents=True)
    rng = np.random.RandomState(3)
    vw = cv2.VideoWriter(str(root / "dataset" / "test" / f"{vid}.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (128, 64))
    base = (rng.rand(64, 128, 3) * 255).astype(np.uint8)
    for t in range(7):
        vw.write(np.roll(base, 4 * t, axis=1))
    vw.release()
    gt = root / "gt" / f"{vid}.mp4"
    gt.mkdir(parents=True)
    for k in range(2, 8):
        np.save(gt / f"{k:05}.npy", rng.rand(8, 16).astype(np.float32))
    for name in ("npz", "pth"):
        (root / f"{name}.yaml").write_text(CONFIG.format(root=root, out=root / f"out_{name}",
                                                         classes=CLASSES))
    tree = jp.init_resnet_params(5, "resnet18", CLASSES)
    jp.save_npz(str(root / "resnet18.npz"), tree)
    _save_pth(root / "resnet18.pth", tw.export_resnet_state_dict(tree, "resnet18"))
    sd = mobilenet_v2_state_dict(2)
    jp.save_npz(str(root / "mobilenet_v2.npz"), jp.convert_mobilenet_v2(sd))
    _save_pth(root / "mobilenet_v2.pth", sd)
    sd = vgg16_bn_state_dict(2)
    jp.save_npz(str(root / "vgg16.npz"), jp.convert_vgg16_bn_features(sd, jp.init_vgg16_params(0)))
    _save_pth(root / "vgg16.pth", sd)
    cl = jp.init_clstm_params(6, CLASSES, CLASSES)  # the state is seeded with a frame
    jp.save_npz(str(root / "clstm.npz"), cl)
    _save_pth(root / "clstm.pth", tw.export_clstm_state_dict(cl))
    return dict(root=root, vid=vid)


def _in(root, fn):
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _arrays(d):
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d)) if f.endswith(".npy")}


@pytest.mark.parametrize("arch", ["resnet18", "vgg16", "mobilenet_v2"])
def test_extract_features_reads_pth(sandbox, arch):
    from cp360_tpu_torch.cli import extract_features

    root, vid = sandbox["root"], sandbox["vid"]
    feats = {}
    for ext in ("npz", "pth"):
        _in(root, lambda: extract_features.main(
            ["--out", "s", "--mode", arch, "-of", "--weights", str(root / f"{arch}.{ext}"),
             "--config", str(root / f"{ext}.yaml"), "--device", "cpu"]))
        feats[ext] = _arrays(root / f"out_{ext}" / f"s_{arch}" / vid / "cube_feat")
    assert sorted(feats["pth"]) == [f"{k:06}.npy" for k in range(2, 8)]
    want_c = 1000 if arch != "resnet18" else CLASSES
    for k, a in feats["npz"].items():
        assert a.shape == (6, want_c, 2, 2)
        np.testing.assert_array_equal(feats["pth"][k], a)


def test_test_temporal_reads_a_pth_clstm(sandbox):
    from cp360_tpu_torch.cli import extract_features, test_temporal

    root, vid = sandbox["root"], sandbox["vid"]
    art = root / "out_npz" / "t_resnet18"
    _in(root, lambda: extract_features.main(
        ["--out", "t", "--mode", "resnet18", "-of", "--weights", str(root / "resnet18.npz"),
         "--config", str(root / "npz.yaml"), "--device", "cpu"]))
    aggs, maps = {}, {}
    for ext in ("npz", "pth"):
        np.random.seed(0)  # the shuffled-AUC baseline draws from the global generator
        aggs[ext] = _in(root, lambda: test_temporal.main(
            ["--model", str(root / f"clstm.{ext}"), "--dir", str(art),
             "--config", str(root / f"{ext}.yaml"), "--device", "cpu"]))
        maps[ext] = _arrays(root / f"out_{ext}" / "temporal" / vid)
    assert maps["npz"] and sorted(maps["pth"]) == sorted(maps["npz"])
    for k in maps["npz"]:
        np.testing.assert_array_equal(maps["pth"][k], maps["npz"][k])
    assert aggs["pth"] == aggs["npz"]


def test_stream_saliency_reads_pth(sandbox):
    from cp360_tpu_torch.cli import stream_saliency

    root, vid = sandbox["root"], sandbox["vid"]
    maps = {}
    for ext in ("npz", "pth"):
        out = root / f"stream_{ext}"
        n = stream_saliency.main(
            ["--video", str(root / "dataset" / "test" / f"{vid}.mp4"), "--arch", "resnet18",
             "--backbone", str(root / f"resnet18.{ext}"), "--clstm", str(root / f"clstm.{ext}"),
             "--out", str(out), "--stage1-batch", "4", "--config", str(root / f"{ext}.yaml"),
             "--device", "cpu"])
        assert n == 4  # 6 artifacts after the lag seed: 4 windows of 3, the final one emitted
        maps[ext] = _arrays(out)
    assert sorted(maps["pth"]) == sorted(maps["npz"])
    for k in maps["npz"]:
        np.testing.assert_array_equal(maps["pth"][k], maps["npz"][k])


def test_serve_reads_pth(sandbox, monkeypatch):
    """``cli.serve`` with ``.pth`` backbone and ConvLSTM builds the model the
    ``.npz`` files build: the same prediction, bit for bit."""
    from cp360_tpu_torch.cli import serve as serve_cli
    from cp360_tpu_torch.serving import server

    root = sandbox["root"]
    frame = (np.random.RandomState(5).rand(64, 128, 3) * 255).astype(np.uint8)
    got = {}

    class Httpd:  # stands in for the HTTP server: one predict, then return
        def __init__(self, model):
            self.model = model

        def serve_forever(self):
            got[self.model.arch, ext] = (self.model.predict(frame),
                                         self.model.clstm is not None)

        def shutdown(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(server, "serve", lambda model, host, port: Httpd(model))
    for arch in ("resnet18", "mobilenet_v2"):
        for ext in ("npz", "pth"):
            argv = ["--mode", arch, "--weights", str(root / f"{arch}.{ext}"),
                    "--config", str(root / f"{ext}.yaml"), "--device", "cpu", "--port", "0"]
            if arch == "resnet18":
                argv += ["--clstm", str(root / f"clstm.{ext}")]
            serve_cli.main(argv)
        (a, ta), (b, tb) = got[arch, "npz"], got[arch, "pth"]
        assert ta == tb == (arch == "resnet18")
        assert a.shape == (4, 8) and np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)
