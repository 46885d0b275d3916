"""PyTorch port, the stage-1 backbone families against the JAX package on the
CPU: ``layers.conv2d`` (padding, tuple strides, groups), the cube conv in
its ``pad`` and ``halo`` forms, ``cube_pad_nchw``, resnet18/34/101/152
(both conv forms), VGG16-BN and MobileNetV2 (f32, and bf16 stage 1), their
CAMs and the torchvision-layout converters.

One numpy tree goes into both packages.  The ResNets take a torchvision-
layout state dict with trained-like batch-norm statistics (scales in
[0.1, 0.5], variances in [0.5, 2]), converted by both packages' converters:
with the He init's unit batch norms the features of resnet101/152 grow to
1e5..1e9 and an absolute tolerance would say nothing.  Tolerances: f32
features and CAMs atol 2e-4 / rtol 1e-3 (tests/test_models.py:63); one
cube conv 2e-5 (tests/test_cube_pad.py:178-181); bf16 ``halo`` within 1e-2
of the largest JAX bf16 feature; bf16 VGG16 and MobileNetV2 CAMs within
4e-3 of the largest JAX bf16 CAM; the seamless-sphere and zero-pad checks of
tests/test_vgg.py:35-56 and tests/test_mobilenet.py:37-58.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.compat import torch_weights as jtw
from cp360_tpu.models import layers as jlayers
from cp360_tpu.models.cam import cam_forward as jax_cam_forward
from cp360_tpu.models.cam import cam_scores as jax_cam_scores
from cp360_tpu.models.mobilenet import (
    convert_mobilenet_v2 as jax_convert_mobilenet,
    mobilenet_v2_apply,
    mobilenet_v2_cam_forward,
)
from cp360_tpu.models.resnet import resnet_apply
from cp360_tpu.models.vgg import (
    convert_vgg16_bn_features as jax_convert_vgg,
    vgg16_apply,
    vgg16_cam_forward,
)
from cp360_tpu.ops import cube_pad as jcp
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.cam import cam_forward
from cp360_tpu_torch.models.mobilenet import V2_CFG
from cp360_tpu_torch.models.vgg import VGG16_CFG
from cp360_tpu_torch.ops import cube_pad as cp

torch.set_num_threads(2)

TOL = dict(atol=2e-4, rtol=1e-3)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _trees_equal(a, b):
    fa, fb = jax_params.flatten_params(a), jax_params.flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ---- layers -------------------------------------------------------------------------


@pytest.mark.parametrize("stride,padding,groups", [
    (1, [(1, 1), (1, 1)], 1),
    ((1, 2), [(1, 1), (0, 0)], 1),
    ((2, 1), [(0, 1), (2, 0)], 1),  # asymmetric pads
    (2, "VALID", 4),
    (2, [(1, 1), (1, 1)], 8),  # depthwise: groups == C, HWIO [3, 3, 1, C]
])
def test_conv2d_equals_jax(stride, padding, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 10, 8).astype(np.float32)
    cout = 8 if groups == 8 else 12
    w = rng.randn(3, 3, 8 // groups, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = jlayers.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                          padding=padding, groups=groups)
    got = layers.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=padding, groups=groups)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_avg_pool_and_linear_equal_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 14, 14, 5).astype(np.float32)
    p = {"w": rng.randn(5, 7).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    np.testing.assert_allclose(layers.avg_pool(_t(x), 7).numpy(),
                               np.asarray(jlayers.avg_pool(jnp.asarray(x), 7)), atol=1e-6)
    y = x[:, 0, 0]
    np.testing.assert_allclose(layers.linear(_t(y), {k: _t(v) for k, v in p.items()}).numpy(),
                               np.asarray(jlayers.linear(jnp.asarray(y), _jax(p))), atol=1e-5)


def test_fold_batch_norm_into_conv_exact():
    """The JAX package's check (tests/test_models.py:154) on the port: the
    folded (w', b') reproduce conv2d -> batch_norm, and equal JAX's fold."""
    rng = np.random.RandomState(0)
    x = _t(rng.randn(2, 8, 8, 3).astype(np.float32))
    w = rng.randn(3, 3, 3, 5).astype(np.float32) * 0.1
    bn = {"scale": rng.rand(5).astype(np.float32) + 0.5,
          "bias": rng.randn(5).astype(np.float32),
          "mean": rng.randn(5).astype(np.float32),
          "var": rng.rand(5).astype(np.float32) + 0.1}
    same = ((1, 1), (1, 1))  # the JAX test's "SAME" for a 3x3 at stride 1
    ref = layers.batch_norm(layers.conv2d(x, _t(w), padding=same),
                            {k: _t(v) for k, v in bn.items()})
    wf, bf = layers.fold_batch_norm_into_conv(w, bn)
    out = layers.conv2d(x, wf, bf, padding=same)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)
    jw, jb = jlayers.fold_batch_norm_into_conv(jnp.asarray(w), _jax(bn))
    np.testing.assert_array_equal(wf.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(bf.numpy(), np.asarray(jb))


# ---- the cube conv --------------------------------------------------------------------


@pytest.mark.parametrize("h,cin,cout,stride", [(8, 5, 7, 1), (8, 5, 7, 2), (14, 3, 4, 1),
                                               (16, 4, 6, 2)])
def test_cube_pad_conv3x3_forms_equal_jax(h, cin, cout, stride):
    """Both forms against JAX's and ``halo`` against the port's ``pad``, at
    the shapes of tests/test_cube_pad.py:178-181."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, h, h, cin).astype(np.float32)
    w = rng.randn(3, 3, cin, cout).astype(np.float32)
    got = {f: cp.cube_pad_conv3x3(_t(x), _t(w), stride=stride, form=f).numpy()
           for f in ("pad", "halo")}
    for form, out in got.items():
        want = np.asarray(jcp.cube_pad_conv3x3(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                               form=form))
        assert out.shape == want.shape == (2, 6, h // stride, h // stride, cout)
        np.testing.assert_allclose(out, want, atol=2e-5, rtol=2e-5, err_msg=form)
    np.testing.assert_allclose(got["halo"], got["pad"], atol=2e-5, rtol=2e-5)


def test_cube_pad_conv3x3_rejects_unknown_form():
    with pytest.raises(ValueError, match="cube-conv form"):
        cp.cube_pad_conv3x3(torch.zeros(1, 6, 8, 8, 2), torch.zeros(3, 3, 2, 2), form="hallo")


def test_cube_pad_nchw_is_bit_exact():
    x = np.random.RandomState(2).randn(12, 3, 8, 8).astype(np.float32)
    for pads in (1, (1, 2, 0, 3)):
        want = np.asarray(jcp.cube_pad_nchw(jnp.asarray(x), pads))
        np.testing.assert_array_equal(cp.cube_pad_nchw(_t(x), pads).numpy(), want)


# ---- ResNets -------------------------------------------------------------------------


def resnet_state_dict(arch, seed, num_classes=1000):
    """A torchvision-layout ResNet state dict: He-initialized convs and
    trained-like batch-norm statistics."""
    rs = np.random.RandomState(seed + 100)
    sd = jtw.export_resnet_state_dict(jax_params.init_resnet_params(seed, arch, num_classes),
                                      arch)
    for k in [k for k in sd if k.endswith("running_var")]:
        pre, n = k[:-len("running_var")], sd[k].shape[0]
        sd[pre + "weight"] = rs.uniform(0.1, 0.5, n).astype(np.float32)
        sd[pre + "bias"] = (rs.randn(n) * 0.1).astype(np.float32)
        sd[pre + "running_mean"] = (rs.randn(n) * 0.1).astype(np.float32)
        sd[k] = rs.uniform(0.5, 2.0, n).astype(np.float32)
    return sd


_TREES = {}


def resnet_tree(arch):
    """The state dict through both packages' converters, which must agree."""
    if arch not in _TREES:
        sd = resnet_state_dict(arch, 3)
        tree = jax_params.convert_resnet_state_dict(sd, arch)
        _trees_equal(tree, jtw.convert_resnet_state_dict(sd, arch))
        _TREES[arch] = tree
    return _TREES[arch]


# resnet152 costs the JAX side about 9 s in pad and 14 s in halo here: one case each
@pytest.mark.parametrize("arch,form", [(a, f) for a in ("resnet18", "resnet34", "resnet101",
                                                        "resnet152")
                                       for f in ("pad", "halo")])
def test_resnet_features_and_cam_equal_jax(arch, form):
    x = np.random.RandomState(1).randn(1, 6, 64, 64, 3).astype(np.float32)
    tree = resnet_tree(arch)
    model = jax_params.resnet_from_params(tree, arch, compute_dtype=torch.float32,
                                          cube_conv_form=form)
    assert model.cube_conv_form == form
    with torch.no_grad():
        scores, feats = cam_forward(model, _t(x))
    # JAX's cam_forward runs the default form: its features come from
    # resnet_apply in the form asked, its scores from the same cam_scores
    _, jfeats = resnet_apply(_jax(tree), jnp.asarray(x), arch=arch, compute_dtype=jnp.float32,
                             with_logits=False, cube_conv_form=form)
    jscores = jax_cam_scores(jfeats, jnp.asarray(tree["fc"]["w"]))
    if form == "pad":
        want, _ = jax_cam_forward(_jax(tree), jnp.asarray(x), arch=arch,
                                  compute_dtype=jnp.float32)
        np.testing.assert_array_equal(np.asarray(jscores).reshape(want.shape), np.asarray(want))
    jscores = np.asarray(jscores).reshape(scores.shape)
    jfeats = np.asarray(jfeats).reshape(feats.shape)
    c = 512 if arch in ("resnet18", "resnet34") else 2048
    assert feats.shape == (1, 6, 2, 2, c) and scores.shape == (1, 6, 2, 2, 1000)
    np.testing.assert_allclose(feats.numpy(), jfeats, **TOL)
    np.testing.assert_allclose(scores.numpy(), jscores, **TOL)


@pytest.mark.parametrize("arch", ["resnet50", "resnet101"])
def test_resnet_bf16_halo_near_jax(arch):
    """bf16 ``halo`` (the bf16 default) against JAX's bf16 ``halo``: both
    round at every conv's store, with other summation orders, so within
    1e-2 of the largest feature."""
    x = np.random.RandomState(4).randn(1, 6, 64, 64, 3).astype(np.float32)
    tree = jax_params.convert_resnet_state_dict(resnet_state_dict(arch, 5), arch)
    model = jax_params.resnet_from_params(tree, arch, compute_dtype=torch.bfloat16)
    assert model.cube_conv_form == "halo"
    with torch.no_grad():
        _, feats = model(_t(x), with_logits=False)
    _, jfeats = resnet_apply(_jax(tree), jnp.asarray(x), arch=arch, compute_dtype=jnp.bfloat16,
                             with_logits=False)
    want = np.asarray(jfeats).astype(np.float32)
    err = np.abs(feats.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype,form", [(torch.float32, "pad"), (torch.bfloat16, "halo")])
def test_default_cube_conv_form_resolves_like_jax(dtype, form):
    model = jax_params.backbone_from_params(jax_params.init_resnet_params(0, "resnet18", 4),
                                            "resnet18", compute_dtype=dtype)
    assert model.cube_conv_form == form


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch 'resnet200'"):
        jax_params.init_backbone_params(0, "resnet200")
    with pytest.raises(ValueError, match="unknown arch 'resnet200'"):
        jax_params.backbone_from_params({}, "resnet200")


# ---- VGG16-BN and MobileNetV2 ---------------------------------------------------------


FAMILIES = {
    "vgg16": (vgg16_apply, vgg16_cam_forward, 1024),
    "mobilenet_v2": (mobilenet_v2_apply, mobilenet_v2_cam_forward, 1280),
}


@pytest.fixture(scope="module")
def family_trees():
    return {a: jax_params.init_backbone_params(6, a, 1000) for a in FAMILIES}


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_features_and_cam_equal_jax(arch, family_trees):
    apply, jcam, c = FAMILIES[arch]
    x = np.random.RandomState(1).randn(2, 6, 64, 64, 3).astype(np.float32)
    tree = family_trees[arch]
    model = jax_params.backbone_from_params(tree, arch, compute_dtype=torch.float32)
    with torch.no_grad():
        logits, feats = model(_t(x))
        scores, _ = cam_forward(model, _t(x))
    jlogits, jfeats = apply(_jax(tree), jnp.asarray(x), compute_dtype=jnp.float32)
    jscores, _ = jcam(_jax(tree), jnp.asarray(x), compute_dtype=jnp.float32)
    assert feats.shape == (12, 2, 2, c) and scores.shape == (2, 6, 2, 2, 1000)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), **TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)
    assert float(scores.min()) >= -1e-5  # the non-negative shifted weight


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_family_constant_sphere_is_seamless(arch, family_trees):
    """A constant sphere gives the same features on all six faces with cube
    padding; zero padding breaks it at the border (tests/test_vgg.py:35-56,
    tests/test_mobilenet.py:37-58)."""
    x = torch.full((1, 6, 64, 64, 3), 0.3)
    f = {}
    for use_cp in (True, False):
        model = jax_params.backbone_from_params(family_trees[arch], arch, use_cube_pad=use_cp,
                                                compute_dtype=torch.float32)
        with torch.no_grad():
            f[use_cp] = model(x, with_logits=False)[1].numpy()
    for face in range(1, 6):
        np.testing.assert_allclose(f[True][face], f[True][0], atol=1e-4)
    assert np.abs(f[False][0, 0, 0] - f[False][0, 1, 1]).max() > 1e-3
    assert np.abs(f[True][0, 0, 0] - f[True][0, 1, 1]).max() < 1e-4


@pytest.mark.parametrize("arch,face", [("vgg16", 64), ("mobilenet_v2", 224)])
def test_family_bf16_cam_near_jax_bf16(arch, face, family_trees):
    """bf16 CAMs against the JAX package's bf16 CAMs on the same faces of
    noise.  Two bf16 forwards that round in other orders drift apart as far
    as the net amplifies a one-ulp change, so the bound is the JAX
    package's own drift: how far its bf16 CAMs move when half the input's
    entries move up by one bf16 ulp.  vgg16 is also held to 2^-8 of the
    largest CAM (one bf16 ulp of it, or less); the seeded mobilenet_v2
    amplifies the ulp to about 2% at 224 faces, in both packages."""
    _, jcam, _ = FAMILIES[arch]
    rs = np.random.RandomState(7)
    xb = torch.from_numpy(rs.randn(1, 6, face, face, 3).astype(np.float32)).bfloat16()
    up = torch.nextafter(xb, torch.full_like(xb, float("inf")))
    moved = torch.where(torch.from_numpy(rs.rand(*xb.shape) < 0.5), up, xb)
    tree = family_trees[arch]
    model = jax_params.backbone_from_params(tree, arch, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        got = cam_forward(model, xb.float())[0].float().numpy()
    want, drifted = (np.asarray(jcam(_jax(tree), jnp.asarray(x.float().numpy()),
                                     compute_dtype=jnp.bfloat16)[0]).astype(np.float32)
                     for x in (xb, moved))
    scale = np.abs(want).max()
    gap, drift = np.abs(got - want).max() / scale, np.abs(drifted - want).max() / scale
    print(f"{arch} {face}: port bf16 vs JAX bf16 {gap}, JAX bf16 one-ulp drift {drift}")
    assert gap <= drift, (gap, drift)
    if arch == "vgg16":
        assert gap <= 2.0 ** -8, gap


def vgg16_bn_state_dict(seed):
    """torchvision ``vgg16_bn`` feature weights with its sequential names
    (tests/test_vgg.py:58)."""
    from torch import nn

    mods, cin = [], 3
    for v in VGG16_CFG:
        if v == "M":
            mods.append(nn.MaxPool2d(2, 2))
        else:
            mods += [nn.Conv2d(cin, v, 3, padding=1), nn.BatchNorm2d(v), nn.ReLU()]
            cin = v
    torch.manual_seed(seed)
    features = nn.Sequential(*mods)
    return {f"features.{k}": v.numpy() for k, v in features.state_dict().items()}


def mobilenet_v2_state_dict(seed):
    """torchvision ``mobilenet_v2`` names (tests/test_mobilenet.py:60)."""
    rs = np.random.RandomState(seed)

    def w(*shape):
        return rs.randn(*shape).astype(np.float32) * 0.1

    def bn(pre, c):
        return {f"{pre}.weight": rs.rand(c).astype(np.float32) + 0.5, f"{pre}.bias": w(c),
                f"{pre}.running_mean": w(c),
                f"{pre}.running_var": rs.rand(c).astype(np.float32) + 0.5,
                f"{pre}.num_batches_tracked": np.zeros((), np.int64)}

    sd = {"features.0.0.weight": w(32, 3, 3, 3), **bn("features.0.1", 32)}
    cin, fi = 32, 1
    for t, c, n, _ in V2_CFG:
        for _ in range(n):
            hidden, pre = cin * t, f"features.{fi}.conv"
            if t != 1:
                sd[f"{pre}.0.0.weight"] = w(hidden, cin, 1, 1)
                sd.update(bn(f"{pre}.0.1", hidden))
                sd[f"{pre}.1.0.weight"] = w(hidden, 1, 3, 3)
                sd.update(bn(f"{pre}.1.1", hidden))
                sd[f"{pre}.2.weight"] = w(c, hidden, 1, 1)
                sd.update(bn(f"{pre}.3", c))
            else:
                sd[f"{pre}.0.0.weight"] = w(hidden, 1, 3, 3)
                sd.update(bn(f"{pre}.0.1", hidden))
                sd[f"{pre}.1.weight"] = w(c, hidden, 1, 1)
                sd.update(bn(f"{pre}.2", c))
            cin, fi = c, fi + 1
    sd["features.18.0.weight"] = w(1280, cin, 1, 1)
    sd.update(bn("features.18.1", 1280))
    sd["classifier.1.weight"] = w(1000, 1280)
    sd["classifier.1.bias"] = w(1000)
    return sd


def test_converters_equal_jax(family_trees):
    sd = vgg16_bn_state_dict(0)
    tree = jax_params.convert_vgg16_bn_features(sd, family_trees["vgg16"])
    _trees_equal(tree, jax_convert_vgg(sd, family_trees["vgg16"]))
    np.testing.assert_array_equal(tree["classifier"]["w"],
                                  family_trees["vgg16"]["classifier"]["w"])  # head kept
    sd = mobilenet_v2_state_dict(0)
    tree = jax_params.convert_mobilenet_v2(sd)
    _trees_equal(tree, jax_convert_mobilenet(sd))
    np.testing.assert_array_equal(tree["blocks"][1]["dw"]["w"],
                                  sd["features.2.conv.1.0.weight"].transpose(2, 3, 1, 0))
    init = jax_params.flatten_params(family_trees["mobilenet_v2"])
    assert {k: v.shape for k, v in jax_params.flatten_params(tree).items()} == {
        k: v.shape for k, v in init.items()}
    for arch in ("resnet18", "resnet34"):  # BasicBlock depths
        sd = resnet_state_dict(arch, 1, 10)
        _trees_equal(jax_params.convert_resnet_state_dict(sd, arch),
                     jtw.convert_resnet_state_dict(sd, arch))


def test_seeded_inits_have_the_jax_structure():
    from cp360_tpu.models.mobilenet import init_mobilenet_v2_params
    from cp360_tpu.models.resnet import init_resnet_params
    from cp360_tpu.models.vgg import init_vgg16_params

    theirs = {"vgg16": lambda k: init_vgg16_params(k, 10),
              "mobilenet_v2": lambda k: init_mobilenet_v2_params(k, 10)}
    for arch in jax_params.BACKBONES:
        mine = jax_params.init_backbone_params(0, arch, 10)
        fn = theirs.get(arch, lambda k, a=arch: init_resnet_params(k, a, 10))
        want = jax.eval_shape(fn, jax.random.PRNGKey(0))
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(want), arch
        for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape and a.dtype == np.float32
    dw = jax_params.init_mobilenet_v2_params(0)["blocks"][3]["dw"]["w"]
    assert abs(dw.std() / np.sqrt(2 / 9) - 1) < 0.05  # the depthwise fan-out is 9


def test_extract_frames_mobilenet_equals_the_jax_dispatch(family_trees, tmp_path):
    """``extract_frames`` with a MobileNetV2 backbone writes what the JAX
    package's ``stage1_batch(arch="mobilenet_v2")`` computes
    (tests/test_mobilenet.py:115), through f16 storage."""
    from cp360_tpu.pipelines import extract as jax_extract
    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.pipelines import extract

    tree = family_trees["mobilenet_v2"]
    model = jax_params.backbone_from_params(tree, "mobilenet_v2", compute_dtype=torch.float32)
    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 256, (32, 64, 3)).astype(np.uint8) for _ in range(4)]
    cfg = Config(equi_h=64, equi_w=32, cube_dim=64, extract_batch=4, opt_flow=False,
                 compute_dtype="float32", feat_dtype="float16", host_cube_remap=False)
    assert extract.extract_frames(model, cfg, iter(frames), str(tmp_path), output_img=False) == 3
    jscores, _ = jax_extract.stage1_batch(_jax(tree), jnp.asarray(np.stack(frames[:3])),
                                          cube_dim=64, arch="mobilenet_v2",
                                          compute_dtype=jnp.float32)
    jscores = np.asarray(jscores).transpose(0, 1, 4, 2, 3)
    for k in range(3):
        got = np.load(tmp_path / "cube_feat" / f"{k + 2:06}.npy")
        assert got.shape == (6, 1000, 2, 2) and got.dtype == np.float16
        # f16 storage (2^-11 relative) on top of the CAM parity
        assert np.abs(got.astype(np.float32) - jscores[k]).max() <= 2e-3 * np.abs(
            jscores[k]).max()
