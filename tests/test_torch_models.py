"""PyTorch port, models: ResNet-50, CAM and the ConvLSTM against the JAX
package and the in-repo goldens from the original PyTorch code.

Weights cross over through the port's compat/jax_params.py: one numpy param
tree goes into both packages.  Tolerances are those the JAX package's own
tests use: resnet50 atol 2e-4 / rtol 1e-3 (tests/test_models.py:63), the
ConvLSTM 1e-4 (tests/test_models.py:78).
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp360_tpu.compat.torch_weights import (
    convert_clstm_state_dict,
    convert_resnet_state_dict,
    save_npz,
)
from cp360_tpu.models import cam_forward as jax_cam_forward
from cp360_tpu.models import clstm_rollout as jax_clstm_rollout
from cp360_tpu.models import init_clstm_params as jax_init_clstm
from cp360_tpu.models import init_resnet_params as jax_init_resnet
from cp360_tpu.models import resnet_apply
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.models.cam import cam_forward
from cp360_tpu_torch.models.clstm import ConvLSTM, clstm_rollout

torch.set_num_threads(2)

GOLDEN = np.load(os.path.join(os.path.dirname(__file__), "golden", "models.npz"))


def synth_tensor(key: str, shape):
    """The golden generator's per-key deterministic tensors
    (tools/gen_golden_models.py, as tests/test_models.py rebuilds them)."""
    rs = np.random.RandomState(zlib.crc32(key.encode()) % (2**31))
    if key.endswith("num_batches_tracked"):
        return np.zeros(shape, np.int64)
    if key.endswith("running_var"):
        return rs.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return (rs.randn(*shape) * 0.05).astype(np.float32)


def golden_state_dict(prefix):
    keys = [str(k) for k in GOLDEN[f"{prefix}_keys"]]
    shapes = [tuple(int(d) for d in s.split(",") if d) for s in GOLDEN[f"{prefix}_shapes"]]
    return {k: synth_tensor(k, s) for k, s in zip(keys, shapes)}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def golden_resnet():
    """The golden nets' weights (small, with BN statistics), so activations
    stay O(1) and the absolute tolerance means what it says."""
    return np_tree(convert_resnet_state_dict(golden_state_dict("resnet50"), "resnet50"))


def test_resnet50_golden(golden_resnet):
    model = jax_params.resnet_from_params(golden_resnet, compute_dtype=torch.float32)
    x = GOLDEN["resnet50_in"].transpose(0, 2, 3, 1)[None]  # [1, 6, 224, 224, 3]
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(np.ascontiguousarray(x)))
    np.testing.assert_allclose(feats.numpy(), GOLDEN["resnet50_feats"].transpose(0, 2, 3, 1),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(logits.numpy(), GOLDEN["resnet50_logits"],
                               atol=2e-4, rtol=1e-3)


def test_resnet50_and_cam_equal_jax(golden_resnet):
    x = np.random.RandomState(1).randn(2, 6, 64, 64, 3).astype(np.float32)
    model = jax_params.resnet_from_params(golden_resnet, compute_dtype=torch.float32)
    with torch.no_grad():
        _, feats = model(torch.from_numpy(x), with_logits=False)
        scores, cam_feats = cam_forward(model, torch.from_numpy(x))
    jparams = jax.tree_util.tree_map(jnp.asarray, golden_resnet)
    _, jfeats = resnet_apply(jparams, jnp.asarray(x), compute_dtype=jnp.float32,
                             with_logits=False)
    jscores, _ = jax_cam_forward(jparams, jnp.asarray(x), compute_dtype=jnp.float32)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(cam_feats.numpy().reshape(feats.shape), feats.numpy())
    assert scores.shape == (2, 6, 2, 2, 1000) and scores.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=2e-4, rtol=1e-3)


def test_resnet_zero_pad_ablation_equals_jax(golden_resnet):
    x = np.random.RandomState(2).randn(1, 6, 32, 32, 3).astype(np.float32)
    model = jax_params.resnet_from_params(golden_resnet, use_cube_pad=False,
                                          compute_dtype=torch.float32)
    with torch.no_grad():
        _, feats = model(torch.from_numpy(x), with_logits=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, golden_resnet)
    _, jfeats = resnet_apply(jparams, jnp.asarray(x), use_cube_pad=False,
                             compute_dtype=jnp.float32, with_logits=False)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-4, rtol=1e-3)


def test_seeded_init_has_the_jax_structure():
    """Same tree, keys and shapes as the JAX package's initializers, so a
    seeded smoke model and a JAX checkpoint load through one converter."""
    mine = jax_params.init_resnet_params(0, "resnet50", 10)
    theirs = jax.eval_shape(lambda k: jax_init_resnet(k, "resnet50", 10),
                            jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(theirs))
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
        assert a.shape == b.shape and a.dtype == np.float32
    c_mine = jax_params.init_clstm_params(0, 6, 5)
    c_theirs = jax.eval_shape(lambda k: jax_init_clstm(k, 6, 5), jax.random.PRNGKey(0))
    for name in ("conv1", "conv2", "gates"):
        for k in ("w", "b"):
            assert c_mine[name][k].shape == c_theirs[name][k].shape
    with pytest.raises(NotImplementedError):
        jax_params.init_resnet_params(0, "resnet18")


def test_npz_written_by_jax_loads(tmp_path):
    rng = np.random.RandomState(3)
    tree = {"conv1": {"w": rng.randn(7, 7, 3, 4).astype(np.float32)},
            "layer1": [{"conv1": {"w": rng.randn(1, 1, 4, 4).astype(np.float32)}},
                       {"bn1": jax_params.bn_params(4)}],
            "fc": {"w": rng.randn(4, 2).astype(np.float32), "b": np.zeros(2, np.float32)}}
    path = str(tmp_path / "params.npz")
    save_npz(path, tree)
    back = jax_params.load_npz(path)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    flat = jax_params.flatten_params(tree)
    assert "layer1/0/conv1/w" in flat
    assert (jax.tree_util.tree_structure(jax_params.unflatten_params(flat))
            == jax.tree_util.tree_structure(tree))


def _clstm_case(seed, b, t, cin, ch):
    rng = np.random.RandomState(seed)
    params = jax_params.init_clstm_params(seed, cin, ch)
    for name in params:  # nonzero biases exercise the bias path
        params[name]["b"] = (rng.randn(*params[name]["b"].shape) * 0.1).astype(np.float32)
    seq = rng.rand(t, b * 6, 7, 7, cin).astype(np.float32)
    h0 = rng.rand(b * 6, 7, 7, ch).astype(np.float32)
    return params, seq, h0


@pytest.mark.parametrize("conv_impl", ["pallas", "xla"])
@pytest.mark.parametrize("use_cube_pad", [True, False])
def test_clstm_rollout_equals_jax(conv_impl, use_cube_pad):
    params, seq, h0 = _clstm_case(4, 2, 3, 8, 8)
    cell = jax_params.clstm_from_params(params, torch.float32, use_cube_pad, conv_impl)
    with torch.no_grad():
        hs, h, c = clstm_rollout(cell, torch.from_numpy(seq), torch.from_numpy(h0),
                                 torch.from_numpy(h0))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jhs, jh, jc = jax_clstm_rollout(jp, jnp.asarray(seq), jnp.asarray(h0), jnp.asarray(h0),
                                    use_cube_pad=use_cube_pad,
                                    compute_dtype=jnp.float32, conv_impl=conv_impl)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_array_equal(h.numpy(), hs.numpy()[-1])


def test_clstm_golden():
    params = np_tree(convert_clstm_state_dict(golden_state_dict("clstm")))
    cell = jax_params.clstm_from_params(params, torch.float32)
    seq = torch.from_numpy(np.ascontiguousarray(
        GOLDEN["clstm_seq"].transpose(0, 1, 3, 4, 2)))  # [3, 6, 7, 7, 8]
    with torch.no_grad():
        hs, _, c = clstm_rollout(cell, seq, seq[0], seq[0])
    np.testing.assert_allclose(hs.numpy(), GOLDEN["clstm_hiddens"].transpose(0, 1, 3, 4, 2),
                               atol=1e-4)
    np.testing.assert_allclose(c.numpy(), GOLDEN["clstm_cells"].transpose(0, 1, 3, 4, 2)[-1],
                               atol=1e-4)


def test_clstm_bf16_close_to_jax():
    params, seq, h0 = _clstm_case(5, 1, 2, 8, 8)
    cell = jax_params.clstm_from_params(params, torch.bfloat16, conv_impl="pallas")
    with torch.no_grad():
        _, h, _ = clstm_rollout(cell, torch.from_numpy(seq), torch.from_numpy(h0),
                                torch.from_numpy(h0))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, jh, _ = jax_clstm_rollout(jp, jnp.asarray(seq), jnp.asarray(h0), jnp.asarray(h0),
                                 compute_dtype=jnp.bfloat16, conv_impl="xla")
    np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32),
                               atol=0.05, rtol=0.05)


@pytest.mark.parametrize("input_size,hidden_size", [(1000, 250), (63, 63)])
def test_padded_cube_conv_clstm_step_equals_jax(monkeypatch, input_size, hidden_size):
    """The bf16 kernels take channels in multiples of 8; other counts
    (hidden_size 250: Cin 1250; hidden_size 63: Cin 126, Cout 252) launch
    on zero-padded operands and slice the result (ops/cube_conv.py
    ``padded_forward`` / ``padded_dx``).  Here the padding runs around the
    plain versions in f32: a ConvLSTM step equals the JAX step (1e-4), and
    the gradients of the train form equal those without the padding."""
    from cp360_tpu_torch.ops import cube_conv

    params, seq, h0 = _clstm_case(6, 1, 1, input_size, hidden_size)
    x = torch.from_numpy(seq)
    h = torch.from_numpy(h0)

    cell = jax_params.clstm_from_params(params, torch.float32, True, "pallas")
    with torch.no_grad():
        plain = clstm_rollout(cell, x, h, h)
    padded_launches = []

    def fwd(x_, w, b):
        padded_launches.append(tuple(w.shape[2:]))
        return cube_conv.padded_forward(cube_conv.cube_conv3x3_plain, x_, w, b)

    monkeypatch.setattr(cube_conv, "cube_conv3x3", fwd)
    monkeypatch.setattr(cube_conv, "cube_conv3x3_dx",
                        lambda dy, w: cube_conv.padded_dx(cube_conv.cube_conv3x3_dx_plain, dy, w))
    with torch.no_grad():
        hs, _, c = clstm_rollout(cell, x, h, h)
    assert padded_launches == [(input_size + hidden_size, 4 * hidden_size),
                               (4 * hidden_size, 4 * hidden_size),
                               (4 * hidden_size, 4 * hidden_size)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jhs, _, jc = jax_clstm_rollout(jp, jnp.asarray(seq), jnp.asarray(h0), jnp.asarray(h0),
                                   compute_dtype=jnp.float32, conv_impl="xla")
    np.testing.assert_array_equal(hs.numpy(), plain[0].numpy())
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-4)
    if hidden_size == 63:  # the train form: dw and dx through the padding
        grads = []
        for patched in (True, False):
            if not patched:
                monkeypatch.undo()
            tcell = jax_params.clstm_from_params(params, torch.float32, True, "pallas")
            xg = x.clone().requires_grad_()
            for p in tcell.buffers():
                p.requires_grad_()
            hs_, _, _ = clstm_rollout(tcell, xg, h, h)
            hs_.square().sum().backward()
            grads.append([xg.grad] + [p.grad for p in tcell.buffers()])
        for a, b in zip(*grads):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_f32_convs_switch_tf32_off():
    """An f32 conv switches cuDNN's TF32 off before it launches, and
    nothing switches it back on (a one-way latch: no race between the
    server's batcher threads); a bf16 conv leaves the flag alone."""
    import threading

    from cp360_tpu_torch.models import layers

    was = torch.backends.cudnn.allow_tf32
    x = torch.randn(2, 5, 5, 4)
    w = torch.randn(3, 3, 4, 6)
    try:
        torch.backends.cudnn.allow_tf32 = True
        layers.conv2d(x, w, compute_dtype=torch.bfloat16)
        assert torch.backends.cudnn.allow_tf32
        layers.conv2d(x, w)
        assert not torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True  # a caller's flag, set again
        after_f32 = []  # the flag as each f32 thread sees it after its conv

        def worker(dtype):
            for _ in range(20):
                layers.conv2d(x, w, compute_dtype=dtype)
                if dtype == torch.float32:
                    after_f32.append(torch.backends.cudnn.allow_tf32)

        threads = [threading.Thread(target=worker, args=(dt,))
                   for dt in (torch.float32, torch.bfloat16, torch.float32, torch.bfloat16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert len(after_f32) == 40 and not any(after_f32)
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = was


def test_clstm_rejects_unknown_conv_impl():
    params = jax_params.init_clstm_params(0, 4, 4)
    convs = {k: {"w": torch.from_numpy(v["w"]), "b": torch.from_numpy(v["b"])}
             for k, v in params.items()}
    with pytest.raises(ValueError):
        ConvLSTM(convs, torch.float32, conv_impl="triton")
    assert ConvLSTM(convs, torch.float32, conv_impl="pallas").hidden_size == 4
