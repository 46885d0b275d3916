"""PyTorch port, the backbones' folded batch norm and the conv epilogue
(``models/layers.py``: ``bn_affine``, ``fold``, ``conv_bn``;
``ops/conv_epilogue.py``).

On the CPU: every family's folded forward in f32 against a plain forward
that runs each batch norm as its own op (``layers.batch_norm``) after the
conv, with random statistics, at 2e-5; a statistic and a weight changed in
place showing in the next call; the bf16 trunk at identity statistics bit
for bit; where ``fold`` puts the scale, and its bf16 kernel and the halo
strips' kernel against the offline fold (``fold_batch_norm_into_conv``,
``halo_kernel``) under random statistics; the epilogue's plain version,
its checks and its gradient, its bf16 x onto an f32 residual, and the
gradient of a recorded card call; no batch norm op left in the trunk.

On the card (``cuda`` marker, skipped without one): the kernel bit for bit
against its plain version in bf16 and f32 (scale and shift, a conv bias, a
residual; ReLU, ReLU6 and none; 64 and 1024 channels; in place and out of
place; and a bf16 x onto an f32 residual), an odd channel count and a
misaligned tensor refused, gradients
through the kernel equal to the plain version's, and each family's bf16
trunk against the plain explicit batch-norm trunk within 1e-2 of its
largest feature.  This file imports neither JAX nor the JAX package, so on a
machine with the card alone:

    python -m pytest tests/test_torch_conv_epilogue.py --noconftest -q
"""

import pytest
import torch

from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.models import cam, layers
from cp360_tpu_torch.models.layers import BatchNorm, pad_faces
from cp360_tpu_torch.models.mobilenet import STRIDES
from cp360_tpu_torch.models.vgg import VGG16_CFG
from cp360_tpu_torch.ops import conv_epilogue as ce
from cp360_tpu_torch.ops import cube_pad as cp_ops

torch.set_num_threads(2)


# ---- the plain explicit batch-norm forward: what the trunk computed before the fold ----


def _bn(x, bn):
    return layers.batch_norm(x, {"scale": bn.scale, "bias": bn.bias, "mean": bn.mean,
                                 "var": bn.var})


def _resnet_explicit(m, x):
    cd, cp = m.compute_dtype, m.use_cube_pad
    out = torch.relu(_bn(m.conv1(pad_faces(x.to(cd), 3, cp), 2, cd), m.bn1))
    if cp and out.shape[1] == out.shape[2] and out.shape[1] % 2 == 0:
        out = cp_ops.cube_pad_max_pool_3x3s2(out.reshape(-1, 6, *out.shape[1:]))
        out = out.reshape(-1, *out.shape[2:])
    else:
        out = layers.max_pool(pad_faces(out, 1, cp), 3, 2)
    for stage in m.stages:
        for blk in stage:
            c, b, s = blk.convs, blk.bns, blk.stride
            if blk.kind == "bottleneck":
                o = torch.relu(_bn(c["conv1"](out, 1, cd), b["bn1"]))
                if blk.w_halo is not None and o.shape[1] == o.shape[2]:
                    o = cp_ops.cube_pad_conv3x3(o.reshape(-1, 6, *o.shape[1:]), c["conv2"].hwio,
                                                s, cd, "halo", blk.w_halo)
                    o = o.reshape(-1, *o.shape[2:])
                else:
                    o = c["conv2"](pad_faces(o, 1, cp), s, cd)
                o = torch.relu(_bn(o, b["bn2"]))
                o = _bn(c["conv3"](o, 1, cd), b["bn3"])
            else:
                pad = ((1, 1), (1, 1))
                o = torch.relu(_bn(c["conv1"](out, s, cd, padding=pad), b["bn1"]))
                o = _bn(c["conv2"](o, 1, cd, padding=pad), b["bn2"])
            res = _bn(c["downsample"](out, s, cd), b["downsample"]) if "downsample" in c else out
            out = torch.relu(o + res)
    return out


def _vgg_explicit(m, x):
    cd, cp = m.compute_dtype, m.use_cube_pad
    out, ci = x.to(cd), 0
    for v in VGG16_CFG:
        if v == "M":
            out = layers.max_pool(out, 2, 2)
            continue
        out = torch.relu(_bn(m.convs[ci](pad_faces(out, 1, cp), 1, cd), m.bns[ci]))
        ci += 1
    return torch.relu(m.camconv(pad_faces(out, 1, cp), 1, cd))


def _mobilenet_explicit(m, x):
    cd, cp = m.compute_dtype, m.use_cube_pad

    def convbn(mod, x, stride=1, groups=1, act=True):
        if mod.conv.w.shape[-1] == 3:
            x = pad_faces(x, 1, cp)
        out = _bn(mod.conv(x, stride, cd, groups=groups), mod.bn)
        return torch.clamp(out, 0.0, 6.0) if act else out

    out = convbn(m.stem, x.to(cd), stride=2)
    for blk, (t, stride) in zip(m.blocks, STRIDES):
        inp = out
        if t != 1:
            out = convbn(blk["expand"], out)
        out = convbn(blk["dw"], out, stride=stride, groups=out.shape[-1])
        out = convbn(blk["project"], out, act=False)
        if stride == 1 and inp.shape[-1] == out.shape[-1]:
            out = inp + out
    return convbn(m.head, out)


def explicit_features(model, x):
    """The CAM features of ``model`` on [N, 6, H, W, 3] faces, every batch
    norm run as its own op after the conv."""
    x = x.reshape(-1, *x.shape[2:])
    arch = model.arch
    fn = {"vgg16": _vgg_explicit, "mobilenet_v2": _mobilenet_explicit}.get(arch, _resnet_explicit)
    return fn(model, x)


def randomize_batch_norms(model, seed, trained_like=False):
    """Non-identity statistics in every batch norm: scale in [0.5, 2], bias
    and mean of std 0.5, var in [0.5, 2], and conv biases (VGG16's) of std
    0.5; ``trained_like``: scale in [0.1, 0.5], bias and mean of std 0.1,
    var in [0.5, 2], conv biases of std 0.05 (tests/test_torch_backbones.py's
    statistics, under which the features stay within a few units)."""
    lo, hi, std, bias_std = (0.1, 0.5, 0.1, 0.05) if trained_like else (0.5, 2.0, 0.5, 0.5)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, layers.Conv) and mod.b is not None:
            mod.b.copy_(bias_std * torch.randn(mod.b.shape, generator=gen))
        if isinstance(mod, BatchNorm):
            c = mod.scale.shape[0]
            for name, v in (("scale", lo + (hi - lo) * torch.rand(c, generator=gen)),
                            ("bias", std * torch.randn(c, generator=gen)),
                            ("mean", std * torch.randn(c, generator=gen)),
                            ("var", 0.5 + 1.5 * torch.rand(c, generator=gen))):
                getattr(mod, name).copy_(v)
    return model


FAMILIES = [("resnet50", "halo"), ("resnet50", "pad"), ("resnet18", None), ("vgg16", None),
            ("mobilenet_v2", None)]
FAMILY_IDS = ["resnet50-halo", "resnet50-pad", "resnet18", "vgg16", "mobilenet_v2"]


def _model(arch, form, dtype, device="cpu", seed=3, trained_like=False):
    params = jax_params.init_backbone_params(seed, arch, num_classes=16)
    model = jax_params.backbone_from_params(params, arch, compute_dtype=dtype, device=device,
                                            cube_conv_form=form)
    return randomize_batch_norms(model, seed + 1, trained_like)


def _faces(n, h, seed, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, 6, h, h, 3), generator=gen, device=device)


# ---- the fold on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("arch,form", FAMILIES, ids=FAMILY_IDS)
def test_folded_forward_equals_the_explicit_batch_norm_forward(arch, form):
    """f32, random statistics: the trunk with each batch norm folded
    (``layers.fold``; in f32 its scale and shift ride the epilogue) against
    conv -> ``layers.batch_norm`` -> residual -> activation as separate ops,
    at atol 2e-5 / rtol 2e-5 (the epilogue runs the same f32 operations in
    the same order, so they agree to the bit); then a statistic and a
    weight changed in place show in the next call."""
    model = _model(arch, form, torch.float32)
    x = _faces(1, 64, 5)
    with torch.no_grad():
        got = model(x, with_logits=False)[1]
        want = explicit_features(model, x)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        bns[len(bns) // 2].var.mul_(3.0)  # a statistic deep in the trunk
        bns[0].mean.add_(0.25)
        next(m for m in model.modules() if isinstance(m, layers.Conv)).w.mul_(0.5)
        changed = model(x, with_logits=False)[1]
        want_changed = explicit_features(model, x)
    assert not torch.allclose(changed, got, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(changed, want_changed, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch,form", FAMILIES, ids=FAMILY_IDS)
def test_bf16_trunk_at_identity_statistics_equals_the_explicit_trunk_bit_for_bit(arch, form):
    """bf16 with the seeded init's statistics at identity, and each residual
    branch's last batch norm scaled by 0.25 (as the benchmark's weights
    are): g = scale / sqrt(1 + eps) folds into the bf16 kernel as the kernel
    itself (times 0.25), so the trunk equals the explicit chain bit for
    bit."""
    params = jax_params.init_backbone_params(3, arch, num_classes=16)
    model = jax_params.backbone_from_params(params, arch, compute_dtype=torch.bfloat16,
                                            cube_conv_form=form)
    for stage in getattr(model, "stages", []):
        for blk in stage:
            blk.bns["bn3" if "bn3" in blk.bns else "bn2"].scale.fill_(0.25)
    x = _faces(2, 64, 5)
    with torch.no_grad():
        got = model(x, with_logits=False)[1]
        want = explicit_features(model, x)
    assert got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("arch,form", FAMILIES, ids=FAMILY_IDS)
def test_the_trunk_runs_no_batch_norm_op(monkeypatch, arch, form):
    """The trunk reads its batch norms through the fold alone: a forward and
    a CAM with ``layers.batch_norm`` refusing."""
    model = _model(arch, form, torch.float32)

    def refuse(*args, **kwargs):
        raise AssertionError("the trunk ran a batch norm op")
    monkeypatch.setattr(layers, "batch_norm", refuse)
    with torch.no_grad():
        scores, feats = cam.cam_forward(model, _faces(1, 32, 6))
    assert torch.isfinite(scores).all() and torch.isfinite(feats).all()


def test_fold_puts_g_in_a_bf16_kernel_and_in_an_f32_epilogue():
    bf16 = _model("vgg16", None, torch.bfloat16)
    conv, bn = bf16.convs[2], bf16.bns[2]
    g, shift = layers.bn_affine(dict(bn.named_buffers()))
    w, folded, shift_, scale, pre = layers.fold(conv, bn, torch.bfloat16)
    assert folded is not None and torch.equal(folded, g) and scale is None and pre is None
    assert w.dtype == torch.bfloat16 and w.stride() == conv.w.stride()
    assert torch.equal(w, (conv.w.float() * g.view(-1, 1, 1, 1)).to(torch.bfloat16))
    assert torch.equal(shift_, shift + g * conv.b.float())
    f32 = _model("vgg16", None, torch.float32)
    conv, bn = f32.convs[2], f32.bns[2]
    w, folded, shift_, scale, pre = layers.fold(conv, bn, torch.float32)
    assert w is conv.w and folded is None and pre is conv.b
    assert all(torch.equal(a, b) for a, b in zip((scale, shift_),
                                                 layers.bn_affine(dict(bn.named_buffers()))))
    w, folded, shift_, scale, pre = layers.fold(f32.camconv, None, torch.float32)
    assert w is f32.camconv.w and shift_ is f32.camconv.b and folded is scale is pre is None


def test_bn_affine_is_what_batch_norm_applies():
    model = _model("vgg16", None, torch.float32)
    bn = model.bns[2]
    scale, shift = layers.bn_affine(dict(bn.named_buffers()))
    torch.testing.assert_close(scale, bn.scale / torch.sqrt(bn.var + 1e-5), atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(shift, bn.bias - bn.mean * scale, atol=1e-6, rtol=1e-6)
    x = torch.randn(2, 3, 3, scale.shape[0], generator=torch.Generator().manual_seed(1))
    assert torch.equal(layers.batch_norm(x, {k: getattr(bn, k) for k in
                                             ("scale", "bias", "mean", "var")}),
                       x * scale + shift)


@pytest.mark.parametrize("stage,stride", [(0, 1), (1, 2)], ids=["stride1", "stride2"])
def test_fold_matches_the_offline_fold_and_scales_the_halo_strips(monkeypatch, stage, stride):
    """bf16 resnet50 ``halo``, random statistics in bn2: the kernel that
    ``_cube_conv`` hands the conv is the offline fold's
    (``fold_batch_norm_into_conv``, f64) rounded once to bf16, within half
    a bf16 ulp; its shift is the offline bias; and the halo strips' kernel
    it hands over is ``halo_kernel`` of that folded kernel, bit for bit
    (each strip's output channel scaled by its own channel's factor)."""
    model = _model("resnet50", "halo", torch.bfloat16)
    blk = model.stages[stage][0]
    assert blk.stride == stride and blk.w_halo is not None
    bn = blk.bns["bn2"]
    seen = {}
    real = cp_ops.cube_pad_conv3x3

    def spy(x, w, s, cd, form, w_halo):
        seen.update(w=w, w_halo=w_halo)
        return real(x, w, s, cd, form, w_halo)
    monkeypatch.setattr(cp_ops, "cube_pad_conv3x3", spy)
    c_in = blk.convs["conv2"].w.shape[1]
    x = torch.randn((6, 8, 8, c_in), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        blk._cube_conv(x.bfloat16(), torch.bfloat16)
    stats = {k: getattr(bn, k).numpy() for k in ("scale", "bias", "mean", "var")}
    w_off, b_off = layers.fold_batch_norm_into_conv(blk.convs["conv2"].hwio.float().numpy(),
                                                    stats)
    w, g = seen["w"], layers.bn_affine(dict(bn.named_buffers()))[0]
    assert w.dtype == torch.bfloat16 and not torch.allclose(g, g[0].expand_as(g))
    half_ulp = 2.0 ** -8 * w_off.abs()  # bf16 keeps 8 significant bits
    assert ((w.float() - w_off).abs() <= half_ulp * (1 + 1e-5)).all()
    _, _, shift, scale, pre = layers.fold(blk.convs["conv2"], bn, torch.bfloat16)
    assert scale is None and pre is None
    torch.testing.assert_close(shift, b_off, atol=1e-6, rtol=1e-6)
    want_halo = cp_ops.halo_kernel(w, stride)
    assert seen["w_halo"].shape == want_halo.shape and torch.equal(seen["w_halo"], want_halo)


def test_a_recorded_card_call_differentiates_the_plain_version(monkeypatch):
    """The autograd form of a card call (the kernel's forward stood in by
    its plain version here): every input's gradient is the plain
    version's, and an input that needs none gets none."""
    monkeypatch.setattr(ce, "_launch", lambda x, shift, scale, pre, res, act, out:
                        out.copy_(ce.plain_epilogue(x, shift, scale, pre, res, act)))
    gen = torch.Generator().manual_seed(6)
    for act in (None, "relu", "relu6"):
        ins = [4 * torch.randn(2, 3, 3, 8, generator=gen)] + \
            [torch.randn(8, generator=gen) for _ in range(3)] + \
            [4 * torch.randn(2, 3, 3, 8, generator=gen)]
        dy = torch.randn(2, 3, 3, 8, generator=gen)
        needs = [True, True, True, False, True]
        got_in = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
        want_in = [t.clone().requires_grad_(n) for t, n in zip(ins, needs)]
        got = ce._Epilogue.apply(*got_in, act)
        want = ce.plain_epilogue(*want_in, act)
        assert torch.equal(got, want.detach())
        got.backward(dy)
        want.backward(dy)
        for g, w, n in zip(got_in, want_in, needs):
            assert (g.grad is None) is (not n)
            if n:
                assert torch.equal(g.grad, w.grad)


# ---- the epilogue's plain version ----------------------------------------------------------


@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_epilogue_runs_each_step_in_f32_and_rounds_once(act, dtype):
    gen = torch.Generator().manual_seed(4)
    x = (4 * torch.randn(2, 3, 5, 7, generator=gen)).to(dtype)
    res = (4 * torch.randn(2, 3, 5, 7, generator=gen)).to(dtype)
    pre, scale, shift = (torch.randn(7, generator=gen) for _ in range(3))
    y = ((x.float() + pre) * scale + shift) + res.float()
    y = {None: y, "relu": torch.relu(y), "relu6": torch.clamp(y, 0.0, 6.0)}[act].to(dtype)
    got = ce.conv_epilogue(x, shift, scale, pre, res, act)
    assert got.dtype == dtype and torch.equal(got, y)
    out = torch.empty_like(x)
    assert ce.conv_epilogue(x, shift, scale, pre, res, act, out=out) is out
    assert torch.equal(out, got)
    assert torch.equal(ce.conv_epilogue(x, act=act), ce.plain_epilogue(x, act=act))
    assert torch.equal(ce.conv_epilogue(x, shift), (x.float() + shift).to(dtype))


def test_the_plain_epilogue_adds_bf16_to_an_f32_residual_and_keeps_f32():
    """ConvNeXt's W2: the bf16 branch onto the f32 residual stream, the
    result rounded to f32 alone, into a new tensor or over the residual."""
    gen = torch.Generator().manual_seed(6)
    x = (4 * torch.randn(2, 3, 5, 8, generator=gen)).bfloat16()
    res = 4 * torch.randn(2, 3, 5, 8, generator=gen)
    pre, scale = torch.randn(8, generator=gen), torch.rand(8, generator=gen)
    want = (x.float() + pre) * scale + res
    got = ce.conv_epilogue(x, None, scale, pre, res)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert ce.conv_epilogue(x, None, scale, pre, res, out=res) is res
    assert torch.equal(res, want)
    with pytest.raises(ValueError, match="residual"):
        ce.conv_epilogue(x.float(), residual=res.bfloat16())


def test_the_epilogue_checks_its_arguments_and_passes_gradients():
    x = torch.randn(2, 4, 4, 6, requires_grad=True)
    shift = torch.randn(6, requires_grad=True)
    scale = torch.rand(6) + 0.5
    with pytest.raises(ValueError, match="unknown activation"):
        ce.conv_epilogue(x, shift, act="silu")
    with pytest.raises(ValueError, match="scale of shape"):
        ce.conv_epilogue(x, shift, scale[:5])
    with pytest.raises(ValueError, match="residual"):
        ce.conv_epilogue(x, shift, residual=torch.zeros(2, 4, 4, 5))
    before = ce.launches
    ce.conv_epilogue(x, shift, scale, residual=x.detach(), act="relu").sum().backward()
    assert ce.launches == before  # the CPU never launches the kernel
    assert torch.equal(shift.grad, (x * scale + shift + x).gt(0).float().sum((0, 1, 2)))
    assert torch.equal(x.grad, (x * scale + shift + x).gt(0).float() * scale)


# ---- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the conv epilogue kernel runs on the card only")
    return torch.device("cuda")


def _bits_equal(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", [True, False], ids=["inplace", "out"])
@pytest.mark.parametrize("c", [64, 1024])
@pytest.mark.parametrize("residual", [False, True], ids=["bias", "bias_residual"])
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_kernel_equals_the_plain_epilogue_bit_for_bit(cuda, dtype, act, residual, c,
                                                           inplace):
    gen = torch.Generator(device="cuda").manual_seed(c)
    x = (4 * torch.randn((3, 9, 11, c), generator=gen, device="cuda")).to(dtype)
    x[0, 0, 0, 0] = float("nan")
    res = (4 * torch.randn((3, 9, 11, c), generator=gen, device="cuda")).to(dtype) \
        if residual else None
    shift, scale = (torch.randn(c, generator=gen, device="cuda") for _ in range(2))
    pre = torch.randn(c, generator=gen, device="cuda") if c == 1024 else None
    with torch.no_grad():
        want = ce.plain_epilogue(x, shift, scale, pre, res, act)
        kept = x.clone()
        before = ce.launches
        out = None if inplace else torch.empty_like(x)
        got = ce.conv_epilogue(x, shift, scale, pre, res, act, out=out)
    torch.cuda.synchronize()
    assert ce.launches == before + 1
    assert (got.data_ptr() == x.data_ptr()) is inplace
    if not inplace:
        assert _bits_equal(x, kept)
    assert _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("into", ["new", "residual"])
@pytest.mark.parametrize("c", [64, 1024])
@pytest.mark.parametrize("act", [None, "relu"])
def test_cuda_f32_residual_form_equals_the_plain_epilogue_bit_for_bit(cuda, act, c, into):
    """A bf16 x onto an f32 residual (ConvNeXt's W2 and its residual
    stream): an f32 result, bit for bit the plain version's, into a new
    tensor or over the residual; x is left as it was."""
    gen = torch.Generator(device="cuda").manual_seed(c + 1)
    x = (4 * torch.randn((3, 9, 11, c), generator=gen, device="cuda")).bfloat16()
    res = 4 * torch.randn((3, 9, 11, c), generator=gen, device="cuda")
    pre, scale = (torch.randn(c, generator=gen, device="cuda") for _ in range(2))
    with torch.no_grad():
        want = ce.plain_epilogue(x, None, scale, pre, res, act)
        kept = x.clone()
        before = ce.launches
        got = ce.conv_epilogue(x, None, scale, pre, res, act,
                               out=res if into == "residual" else None)
    torch.cuda.synchronize()
    assert ce.launches == before + 1 and got.dtype == torch.float32
    assert (got.data_ptr() == res.data_ptr()) is (into == "residual")
    assert _bits_equal(x, kept) and _bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["bias", "bias_residual"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_gelu_is_the_plain_epilogue_within_one_ulp(cuda, dtype, residual):
    """GELU is the kernel's one activation that is not bit for bit: its
    erff (within 2 ulp) and the plain version's erf may differ in the last
    bits of the f32 value, so the stored values agree within one ulp of
    the storage dtype in bf16 (2^-7 of the value), and within 2^-20 of it
    in f32 (a few ulps); the rest of the pass is exact either way."""
    gen = torch.Generator(device="cuda").manual_seed(27)
    x = (4 * torch.randn((3, 9, 11, 512), generator=gen, device="cuda")).to(dtype)
    res = (4 * torch.randn((3, 9, 11, 512), generator=gen, device="cuda")).to(dtype) \
        if residual else None
    pre, scale = torch.randn(512, generator=gen, device="cuda"), None
    if residual:
        scale = torch.rand(512, generator=gen, device="cuda") + 0.1
    with torch.no_grad():
        want = ce.plain_epilogue(x, None, scale, pre, res, "gelu")
        before = ce.launches
        got = ce.conv_epilogue(x, None, scale, pre, res, "gelu")
    torch.cuda.synchronize()
    assert ce.launches == before + 1
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_kernel_refuses_an_odd_channel_count_and_a_misaligned_tensor(cuda, dtype):
    """The kernel moves 16 bytes of channels a thread: 37 channels, and a
    tensor 2 or 4 bytes off a 16-byte boundary, are refused, not served
    by another path."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    shift = torch.randn(64, generator=gen, device="cuda")
    odd = torch.randn((2, 5, 5, 37), generator=gen, device="cuda").to(dtype)
    buf = torch.randn(1 + 2 * 5 * 5 * 64, generator=gen, device="cuda").to(dtype)
    off = buf[1:].view(2, 5, 5, 64)
    aligned = torch.randn((2, 5, 5, 64), generator=gen, device="cuda").to(dtype)
    before = ce.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiple of 16"):
            ce.conv_epilogue(odd, shift[:37], act="relu")
        for x, res in ((off, None), (aligned, off)):
            with pytest.raises(ValueError, match="aligned"):
                ce.conv_epilogue(x, shift, residual=res, act="relu")
    assert ce.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "relu6"])
def test_cuda_gradients_through_the_kernel_are_the_plain_versions(cuda, act):
    """With autograd recording, the kernel writes a new tensor (x is kept)
    and the gradients equal the plain version's on the card; with grad
    mode on and nothing that needs a gradient, it writes over x."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = 4 * torch.randn((3, 9, 11, 64), generator=gen, device="cuda")
    res = 4 * torch.randn((3, 9, 11, 64), generator=gen, device="cuda")
    shift, scale = (torch.randn(64, generator=gen, device="cuda") for _ in range(2))
    dy = torch.randn((3, 9, 11, 64), generator=gen, device="cuda")
    got_in = [t.clone().requires_grad_() for t in (x, shift, scale, res)]
    want_in = [t.clone().requires_grad_() for t in (x, shift, scale, res)]
    before = ce.launches
    got = ce.conv_epilogue(got_in[0], got_in[1], got_in[2], None, got_in[3], act)
    assert ce.launches == before + 1 and got.data_ptr() != got_in[0].data_ptr()
    want = ce.plain_epilogue(want_in[0], want_in[1], want_in[2], None, want_in[3], act)
    got.backward(dy)
    want.backward(dy)
    torch.cuda.synchronize()
    assert _bits_equal(got.detach(), want.detach())
    for g, w in zip(got_in, want_in):
        torch.testing.assert_close(g.grad, w.grad, atol=0, rtol=0)
    plain = x.clone()
    y = ce.conv_epilogue(plain, shift, scale, None, res, act)  # grad mode on, no grad needed
    assert ce.launches == before + 2 and y.data_ptr() == plain.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,form", [f for f in FAMILIES if f[1] != "pad"],
                         ids=[i for i, f in zip(FAMILY_IDS, FAMILIES) if f[1] != "pad"])
def test_cuda_bf16_trunk_near_the_explicit_batch_norm_trunk(cuda, monkeypatch, arch, form):
    """bf16 at full width on two frames of 224 faces, random trained-like
    statistics: the trunk (the epilogue kernel, no batch norm op) within
    1e-2 of the largest feature of the plain explicit batch-norm trunk on
    the same card, and no farther from the f32 trunk than that explicit
    bf16 trunk is, give or take 2e-3 (it rounds each activation once where
    the explicit trunk rounds two or three times).

    Under the wider statistics of the CPU test (scales to 2 over variances
    from 0.5) no bf16 trunk holds 1e-2: the features reach 2e6 in
    resnet50, and moving half the input's entries by one bf16 ulp moves
    the explicit bf16 trunk by 2.7% of its largest feature (resnet50) and
    by all of it (mobilenet_v2), as measured on the CPU at 96 faces."""
    model = _model(arch, form, torch.bfloat16, device="cuda", seed=11, trained_like=True)
    f32 = _model(arch, "pad" if form else None, torch.float32, device="cuda", seed=11,
                 trained_like=True)
    x = _faces(2, 224, 12, device="cuda").bfloat16().float()
    with torch.no_grad():
        want = explicit_features(model, x).float()
        exact = explicit_features(f32, x).float()
        monkeypatch.setattr(layers, "batch_norm", None)  # the trunk must not call it
        before = ce.launches
        got = model(x, with_logits=False)[1].float()
    torch.cuda.synchronize()
    assert ce.launches > before
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * scale, (err, scale)
    mine, theirs = ((t - exact).abs().max().item() for t in (got, want))
    assert mine <= theirs + 2e-3 * scale, (mine, theirs, scale)
