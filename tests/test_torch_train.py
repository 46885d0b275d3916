"""PyTorch port, the training slice, against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port; the JAX side runs as its own tests run it (the Pallas kernel in
interpret mode).  Sizes are cut for the CPU (ConvLSTM 8 or 16 channels,
flows 16x32 or 48x96); the code path is the full-width one.

Tolerances: resampling at 1e-5 (f32); loss parts at 1e-5 relative; the
conv gradients at atol/rtol 2e-3, as tests/test_pallas_kernels.py holds
the Pallas VJP; a train step against the JAX step at 1e-4 relative on the
losses and 5e-4 on the weights, as tests/test_pallas_kernels.py holds the
two JAX conv paths against each other; the goldens at the JAX goldens'
own tolerances (tests/test_train_golden.py, tests/test_train_trajectory.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cp360_tpu.compat import torch_weights as jax_weights
from cp360_tpu.config import Config as JaxConfig
from cp360_tpu.models.clstm import clstm_rollout as jax_clstm_rollout
from cp360_tpu.ops import pallas_kernels
from cp360_tpu.ops import resample as jax_resample
from cp360_tpu.train import loop as jax_loop
from cp360_tpu.train import losses as jax_losses
from cp360_tpu_torch.cli import train_temporal
from cp360_tpu_torch.compat import jax_params
from cp360_tpu_torch.config import Config
from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset, builtin_split
from cp360_tpu_torch.models.clstm import clstm_rollout
from cp360_tpu_torch.ops import cube_conv, resample
from cp360_tpu_torch.train import checkpoint, loop, losses

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _close(got, want, rel, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + atol, (err, np.abs(want).max())


# ---- resampling and losses ------------------------------------------------------


def _grid(rng, n, h, w, spread=1.2):
    return rng.uniform(-spread, spread, (n, h, w, 2)).astype(np.float32)


def test_grid_sample_equals_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 13, 3).astype(np.float32)
    g = _grid(rng, 2, 5, 7)
    got = resample.grid_sample(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    want = np.asarray(jax_resample.grid_sample(jnp.asarray(x), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_grid_sample_integer_input_equals_jax():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (1, 8, 8, 3)).astype(np.uint8)
    g = _grid(rng, 1, 4, 4, spread=1.0)
    got = resample.grid_sample(torch.from_numpy(x), torch.from_numpy(g))
    want = np.asarray(jax_resample.grid_sample(jnp.asarray(x), jnp.asarray(g)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_warp_upsampled_equals_jax():
    rng = np.random.RandomState(2)
    p = rng.rand(3, 7, 14).astype(np.float32)
    g = _grid(rng, 3, 16, 32)
    got = resample.warp_upsampled(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    want = np.asarray(jax_resample.warp_upsampled(jnp.asarray(p), jnp.asarray(g)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,out", [((7, 14), (16, 32)), ((14, 28), (48, 96))])
def test_resize_bilinear_equals_jax(hw, out):
    rng = np.random.RandomState(3)
    x = rng.randn(2, *hw, 2).astype(np.float32)
    got = resample.resize_bilinear(torch.from_numpy(x), *out).numpy()
    want = np.asarray(jax_resample.resize_bilinear(jnp.asarray(x), *out))
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(resample._resize_matrix(hw[0], out[0]),
                                  jax_resample._resize_matrix(hw[0], out[0]))


def _loss_case(seed, pairs=3, b=2, fh=16, fw=32):
    rng = np.random.RandomState(seed)
    preds = rng.rand(pairs + 1, b, 7, 14).astype(np.float32)
    flows = (rng.randn(pairs, b, fh, fw, 2) * 1.5).astype(np.float32)
    return preds, flows


def test_losses_equal_jax():
    preds, flows = _loss_case(4)
    got = losses.weak_supervision_losses(torch.from_numpy(preds), torch.from_numpy(flows),
                                         mm_th=0.15, flow_h=16)
    want = jax_losses.weak_supervision_losses(jnp.asarray(preds), jnp.asarray(flows),
                                              mm_th=0.15, flow_h=16)
    for key in ("smooth", "temporal", "mask"):
        _close(got[key].item(), float(want[key]), rel=1e-5)
    _close(losses.total_loss(got, 0.7, 1.0, 0.01).item(),
           float(jax_losses.total_loss(want, 0.7, 1.0, 0.01)), rel=1e-5)
    grid = np.asarray(jax_losses.flow_warp_grid(jnp.asarray(flows[0])))
    np.testing.assert_allclose(losses.flow_warp_grid(torch.from_numpy(flows[0])).numpy(),
                               grid, atol=1e-6)


def test_loss_gradient_only_through_next_equals_jax():
    """Gradients reach p_{t+1} only (warp, current frame and masked target
    are detached), and equal JAX's."""
    preds, flows = _loss_case(5)
    tp = torch.from_numpy(preds).requires_grad_()
    parts = losses.weak_supervision_losses(tp, torch.from_numpy(flows), 0.15, 16)
    losses.total_loss(parts, 0.7, 1.0, 0.01).backward()

    def f(p):
        return jax_losses.total_loss(
            jax_losses.weak_supervision_losses(p, jnp.asarray(flows), 0.15, 16), 0.7, 1.0, 0.01)

    want = np.asarray(jax.grad(f)(jnp.asarray(preds)))
    assert np.all(want[0] == 0) and np.all(tp.grad.numpy()[0] == 0)
    _close(tp.grad.numpy(), want, rel=1e-5)


def test_window_normalize_equals_jax():
    x = np.random.RandomState(6).randn(3, 6, 7, 7, 4).astype(np.float32)
    got = losses.window_normalize(torch.from_numpy(x))
    want = jax_losses.window_normalize(jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# ---- the conv's gradient: the dx tap table, dx, dw, db -----------------------------


@pytest.mark.parametrize("h", [7, 4])
def test_dx_slot_table_reproduces_scatter_matrix(h):
    """The dx kernel's [9, P, 3] tap table, one-hot per entry, gives the TPU
    kernel's scatter matrix B2[q, k*rows + p] = [src_k(p) == q]; each (k, q)
    lists its p in ascending order, -1 after them."""
    rows = 6 * h * h
    tab = cube_conv.dx_tap_table(h, h)
    assert tab.dtype == np.int32 and tab.shape == (9, rows, 3)
    b2 = np.zeros((rows, 9 * rows), np.float32)
    q = np.arange(rows)
    for k in range(9):
        for j in range(3):
            ok = tab[k, :, j] >= 0
            np.add.at(b2, (q[ok], k * rows + tab[k, ok, j]), 1.0)
    np.testing.assert_array_equal(b2, pallas_kernels.build_scatter_matrix(h, h))
    filled = tab >= 0
    assert not (filled[:, :, 1:] & ~filled[:, :, :-1]).any()  # -1 only at the end
    both = filled[:, :, 1:] & filled[:, :, :-1]
    assert (tab[:, :, 1:] > tab[:, :, :-1])[both].all()
    # per tap, the most outputs that read one pixel: 3 at the corner taps,
    # 2 at the edge taps, 1 at the centre (23 of the 27 layers are used)
    assert filled.sum(axis=1).astype(bool).sum(axis=1).tolist() == [3, 3, 3, 2, 1, 2, 3, 3, 3]


@pytest.mark.parametrize("h", [7, 4])
def test_dx_gather_tables_rebuild_the_tap_table(h):
    """The kernel's [9, P] table and its pre-summed rows list exactly the
    [9, P, 3] tap table's rows: single rows in place, pairs and triples as
    rows of the pre-summed buffer, each listed once."""
    tab3 = cube_conv.dx_tap_table(h, h)
    tab, sources = cube_conv.dx_gather_tables(h, h)
    assert tab.shape == (9, 6 * h * h) and sources.shape[1] == 3
    count = (tab3 >= 0).sum(axis=2)
    assert len(sources) == int((count >= 2).sum())
    rebuilt = np.full_like(tab3, -1)
    one, multi = tab >= 0, tab <= -2
    rebuilt[one, 0] = tab[one]
    rebuilt[multi] = sources[-2 - tab[multi]]
    np.testing.assert_array_equal(rebuilt, tab3)
    assert sorted((-2 - tab[multi]).tolist()) == list(range(len(sources)))
    if h == 7:
        assert len(sources) == 188


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def test_dx_slot_sum_equals_autograd_of_plain():
    """The bf16 dx kernel's arithmetic, emulated in numpy through its
    tables: per tap, the <= 3 dy rows of each input pixel summed in f32 and
    rounded once to bf16 (only pairs with 2 or 3 rows have a sum to round),
    then the product with W[tap]^T summed over the taps in f32.  It equals
    autograd of the plain cube pad + conv in f32 (on the same bf16 inputs)
    within the card tests' bf16 tolerance, 1e-2 of max|ref|; with the
    rounding left out it equals it to f64 rounding."""
    rng = np.random.RandomState(7)
    dy = _bf16(rng.randn(2, 6, 7, 7, 24))
    w = _bf16(rng.randn(3, 3, 16, 24) * 0.1)
    tab, sources = cube_conv.dx_gather_tables(7, 7)
    dy2, w9 = dy.reshape(2, 294, 24).astype(np.float64), w.reshape(9, 16, 24)

    def emulate(round_rows):
        # the pre-pass: each cube's multi-source rows, summed, rounded once
        sums = np.zeros((2, len(sources), 24))
        for j in range(3):
            ok = sources[:, j] >= 0
            sums[:, ok] += dy2[:, sources[ok, j]]
        if round_rows:
            sums = _bf16(sums.astype(np.float32))
        # the GEMM: one source row per (tap, pixel), f32 (here f64) sums
        out = np.zeros((2, 294, 16))
        for k in range(9):
            a = np.zeros((2, 294, 24))
            one, multi = tab[k] >= 0, tab[k] <= -2
            a[:, one] = dy2[:, tab[k, one]]
            a[:, multi] = sums[:, -2 - tab[k, multi]]
            out += a @ w9[k].T
        return out

    ref = cube_conv.cube_conv3x3_dx(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    ref = ref.reshape(2, 294, 16)
    np.testing.assert_allclose(emulate(False), ref, atol=1e-5)
    err = np.abs(emulate(True) - ref).max()
    assert err <= 1e-2 * np.abs(ref).max(), err
    exact = cube_conv.cube_conv3x3_dx(torch.from_numpy(dy).double(),
                                      torch.from_numpy(w).double()).numpy()
    np.testing.assert_allclose(emulate(False), exact.reshape(2, 294, 16), atol=1e-12)


def _conv_case(seed, n=2, cin=16, cout=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6, 7, 7, cin).astype(np.float32),
            (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32),
            rng.randn(cout).astype(np.float32),
            rng.randn(n, 6, 7, 7, cout).astype(np.float32))


def test_cube_conv_train_grads_equal_jax_vjp_and_autograd():
    x, w, b, g = _conv_case(8)

    def f_jax(x, w, b):
        return jnp.sum(pallas_kernels.cube_conv3x3_train(x, w, b, True) * g)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (cube_conv.cube_conv3x3_train(tx, tw, tb) * torch.from_numpy(g)).sum().backward()
    px, pw, pb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (cube_conv.cube_conv3x3_plain(px, pw, pb) * torch.from_numpy(g)).sum().backward()
    for name, got, jw, pl in zip(("dx", "dw", "db"), (tx.grad, tw.grad, tb.grad), want,
                                 (px.grad, pw.grad, pb.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jw), atol=2e-3, rtol=2e-3,
                                   err_msg=name)
        np.testing.assert_allclose(got.numpy(), pl.numpy(), atol=2e-3, rtol=2e-3,
                                   err_msg=name)


def test_cube_conv_train_bf16_rounds_weight_grads_then_widens():
    """With f32 masters and bf16 compute copies, dw and db arrive in f32
    but hold bf16 values (rounded once, as the JAX cast's VJP does), and x
    that needs no gradient gets no dx."""
    x, w, b, g = _conv_case(9, n=1, cin=16, cout=8)
    tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    xb = torch.from_numpy(x).bfloat16()
    before = cube_conv.dx_launches
    out = cube_conv.cube_conv3x3_train(xb, tw, tb, tw.bfloat16(), tb.bfloat16())
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert tw.grad.dtype == torch.float32 and xb.grad is None
    assert torch.equal(tw.grad, tw.grad.bfloat16().float())
    assert torch.equal(tb.grad, tb.grad.bfloat16().float())
    assert cube_conv.dx_launches == before  # CPU tensors run the plain versions
    dw_ref, db_ref = cube_conv.cube_conv3x3_wgrad(
        xb.double(), torch.from_numpy(g).bfloat16().double())
    # bf16 dy_k and one bf16 rounding of dw: within 1e-2 of the largest value
    _close(tw.grad.numpy(), dw_ref.numpy(), rel=1e-2)
    _close(tb.grad.numpy(), db_ref.numpy(), rel=1e-2)


# ---- the trainable ConvLSTM ---------------------------------------------------------


def _clstm_params(seed, cin, ch):
    rng = np.random.RandomState(seed)
    params = jax_params.init_clstm_params(seed, cin, ch)
    for name in params:  # nonzero biases exercise the bias gradient
        params[name]["b"] = (rng.randn(*params[name]["b"].shape) * 0.1).astype(np.float32)
    return params


def test_trainable_rollout_equals_serving_and_remat_grads():
    """The trainable cell's rollout equals the serving cell's and JAX's;
    per-step checkpointing (train_remat) gives the same gradients."""
    params = _clstm_params(10, 8, 8)
    seq = np.random.RandomState(11).rand(3, 6, 7, 7, 8).astype(np.float32)
    tseq = torch.from_numpy(seq)
    serve = jax_params.clstm_from_params(params, torch.float32)
    with torch.no_grad():
        want, _, _ = clstm_rollout(serve, tseq, tseq[0], tseq[0])
    jhs, _, _ = jax_clstm_rollout(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(seq), jnp.asarray(seq[0]), jnp.asarray(seq[0]),
                                  compute_dtype=jnp.float32)
    grads = []
    for remat in (False, True):
        cell = jax_params.clstm_from_params(params, torch.float32, trainable=True)
        hs, _, _ = clstm_rollout(cell, tseq, tseq[0], tseq[0], remat=remat)
        np.testing.assert_allclose(hs.detach().numpy(), want.numpy(), atol=1e-6)
        hs.square().sum().backward()
        grads.append([p.grad.clone() for p in cell.parameters()])
    np.testing.assert_allclose(want.numpy(), np.asarray(jhs), atol=1e-4)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_state_is_f32_after_the_first_step():
    params = _clstm_params(12, 8, 8)
    cell = jax_params.clstm_from_params(params, torch.bfloat16, trainable=True)
    assert all(p.dtype == torch.float32 for p in cell.parameters())
    seq = torch.from_numpy(np.random.RandomState(13).rand(2, 6, 7, 7, 8).astype(np.float32))
    hs, h, c = clstm_rollout(cell, seq, seq[0], seq[0])
    assert hs.dtype == h.dtype == c.dtype == torch.float32
    weights = cell.weights()
    assert weights["conv1"][2].dtype == torch.bfloat16
    assert weights["conv1"][0] is cell.conv1_w


# ---- one train step against the JAX step -----------------------------------------


def _step_batch(seed, b=1, ch=8, fh=8, fw=16):
    rng = np.random.RandomState(seed)
    seq = rng.rand(b, 5, 6, 7, 7, ch).astype(np.float32)
    flows = (rng.randn(b, 5, fh, fw, 2) * 2).astype(np.float32)
    return seq, flows


def _port_step(cfg, params, seq, flows, steps=1):
    model = loop.trainable_clstm(cfg, params, "cpu")
    opt = loop.make_optimizer(cfg, model)
    step = loop.make_train_step(cfg, model, opt)
    metrics = [step(torch.from_numpy(seq), torch.from_numpy(flows)) for _ in range(steps)]
    return model, opt, metrics


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_step_equals_jax_make_train_step(impl):
    params = _clstm_params(14, 8, 8)
    seq, flows = _step_batch(15, b=2)
    kw = dict(input_size=8, hidden_size=8, flow_h=8, compute_dtype="float32", lr=1e-3,
              clstm_conv_impl=impl)
    jcfg = JaxConfig(**kw)
    jopt = jax_loop.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp2, _, jm = jax_loop.make_train_step(jcfg, jopt)(jp, jopt.init(jp), jnp.asarray(seq),
                                                       jnp.asarray(flows))
    model, _, (m,) = _port_step(Config(**kw), params, seq, flows)
    for key in ("loss", "smooth", "temporal", "mask"):
        _close(m[key].item(), float(jm[key]), rel=1e-4)
    got = jax_params.clstm_to_params(model)
    for name in got:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[name][k], np.asarray(jp2[name][k]),
                                       atol=5e-4, rtol=5e-4, err_msg=f"{name}/{k}")


def test_bf16_train_step_losses_close_to_jax():
    """bf16 convs (K1 numerics: f32 accumulation, one rounding) against the
    JAX pallas path, whose kernel rounds the tap sums to bf16 as well: the
    losses agree to bf16 precision; the masters stay f32."""
    params = _clstm_params(16, 8, 8)
    seq, flows = _step_batch(17)
    kw = dict(input_size=8, hidden_size=8, flow_h=8, compute_dtype="bfloat16", lr=1e-3,
              clstm_conv_impl="pallas")
    jcfg = JaxConfig(**kw)
    jopt = jax_loop.make_optimizer(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, _, jm = jax_loop.make_train_step(jcfg, jopt)(jp, jopt.init(jp), jnp.asarray(seq),
                                                     jnp.asarray(flows))
    model, _, (m,) = _port_step(Config(**kw), params, seq, flows)
    for key in ("smooth", "temporal"):
        _close(m[key].item(), float(jm[key]), rel=3e-2)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---- the goldens from the reference's own training run ----------------------------


def _golden(name):
    with np.load(os.path.join(GOLDEN, name)) as f:
        return dict(f)


def _golden_windows(golden, root):
    vid = "KC5YDoqVkBE_6"
    for sub, prefix in (("cube_feat", "feat/"), ("motion", "flow/")):
        (root / vid / sub).mkdir(parents=True)
        for key, arr in golden.items():
            if key.startswith(prefix):
                np.save(root / vid / sub / f"{int(key[len(prefix):]):06}.npy", arr)
    return WindowDataset(str(root), str(root), [vid], seq_len=5)


def _golden_cfg(golden):
    return Config(input_size=int(golden["ch"]), hidden_size=int(golden["ch"]),
                  flow_h=int(golden["flow_h"]), lr=float(golden["lr"]),
                  compute_dtype="float32")


def _sd(golden, prefix):
    return {k[len(prefix):]: v for k, v in golden.items() if k.startswith(prefix)}


def test_train_step_matches_reference_golden(tmp_path):
    golden = _golden("train_e2e.npz")
    ds = _golden_windows(golden, tmp_path)
    assert len(ds) == 1
    seq, flows, _, start = ds[0]
    assert start == 2
    params = jax_params.convert_clstm_state_dict(_sd(golden, "init/"))
    model, _, (m,) = _port_step(_golden_cfg(golden), params, seq[None], flows[None])

    crit = golden["crit_vals"]
    for key, w in (("smooth", crit[0::3].sum()), ("temporal", crit[1::3].sum()),
                   ("mask", crit[2::3].sum())):
        assert abs(m[key].item() - w) < 2e-3 * (1 + abs(w)), (key, m[key].item(), w)
    want = jax_params.convert_clstm_state_dict(_sd(golden, "post/"))
    got = jax_params.clstm_to_params(model)
    for name in want:
        for k in ("w", "b"):
            g, w, i0 = got[name][k], want[name][k], params[name][k]
            np.testing.assert_allclose(g, w, atol=5e-5, rtol=1e-4)
            np.testing.assert_allclose(g - i0, w - i0, atol=2e-5)


def test_train_trajectory_tracks_reference_golden(tmp_path):
    golden = _golden("train_traj.npz")
    ds = _golden_windows(golden, tmp_path)
    by_start = {}
    for i in range(len(ds)):
        seq, flows, _, start = ds[i]
        by_start[start] = (seq[None], flows[None])
    order = [int(s) for s in golden["order"]]
    assert sorted(by_start) == sorted(order)

    cfg = _golden_cfg(golden)
    model = loop.trainable_clstm(cfg, jax_params.convert_clstm_state_dict(
        _sd(golden, "init/")), "cpu")
    step = loop.make_train_step(cfg, model, loop.make_optimizer(cfg, model))
    crit = golden["crit_vals"].reshape(-1, 9)
    snaps = {int(s): pos for pos, s in enumerate(golden["steps_idx"])}
    names = sorted(k[6:] for k in golden if k.startswith("steps/"))
    worst = 0.0
    for n, start in enumerate(order):
        m = step(*(torch.from_numpy(a) for a in by_start[start]))
        for key, w in (("smooth", crit[n, 0::3].sum()), ("temporal", crit[n, 1::3].sum()),
                       ("mask", crit[n, 2::3].sum())):
            rel = abs(m[key].item() - w) / (1 + abs(w))
            worst = max(worst, rel)
            assert rel < 2e-3, (n, key, m[key].item(), w)
        if n in snaps:
            want = jax_params.convert_clstm_state_dict(
                {k: golden[f"steps/{k}"][snaps[n]] for k in names})
            got = jax_params.clstm_to_params(model)
            for name in want:
                for k in ("w", "b"):
                    np.testing.assert_allclose(got[name][k], want[name][k], atol=2e-4,
                                               rtol=2e-3, err_msg=f"step {n}")
    assert worst < 1.5e-3, worst


# ---- optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(lr_warmup_steps=4),
    dict(lr_schedule="cosine", lr_warmup_steps=3, lr_total_steps=12),
    dict(lr_schedule="cosine", lr_total_steps=9),
    dict(lr_schedule="linear", lr_warmup_steps=2, lr_total_steps=10),
    dict(lr_schedule="linear", lr_total_steps=5),
])
def test_lr_schedules_equal_optax(kw):
    mine = loop.lr_schedule_from_config(Config(lr=1e-3, **kw))
    theirs = jax_loop.lr_schedule_from_config(JaxConfig(lr=1e-3, **kw))
    for count in range(16):
        got = mine(count) if callable(mine) else mine
        want = float(theirs(count)) if callable(theirs) else theirs
        assert abs(got - want) <= 1e-6 * 1e-3, (count, got, want)


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip_norm=0.05),
                                dict(lr_warmup_steps=2)])
def test_adam_updates_equal_optax(kw):
    """Three updates of torch Adam (+ the optax-formula clip, + a schedule)
    equal optax's on the same gradients."""
    cfg = Config(lr=1e-2, input_size=4, hidden_size=4, **kw)
    params = _clstm_params(18, 4, 4)
    rng = np.random.RandomState(19)
    grads = [{n: {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
              for n, p in params.items()} for _ in range(3)]
    tx = jax_loop.make_optimizer(JaxConfig(**cfg.__dict__))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    model = loop.trainable_clstm(cfg, params, "cpu")
    opt = loop.make_optimizer(cfg, model)
    sched = loop.lr_schedule_from_config(cfg)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for name, key in loop.PARAM_ORDER:
            getattr(model, f"{name}_{key}").grad = torch.from_numpy(g[name][key])
        if cfg.grad_clip_norm:
            loop.clip_by_global_norm_([p.grad for p in model.parameters()],
                                      cfg.grad_clip_norm)
        if callable(sched):
            opt.param_groups[0]["lr"] = sched(loop.update_count(opt))
        opt.step()
    got = jax_params.clstm_to_params(model)
    for name in got:
        for k in ("w", "b"):
            np.testing.assert_allclose(got[name][k], np.asarray(jp[name][k]),
                                       atol=1e-6, rtol=1e-5)


# ---- checkpoints ------------------------------------------------------------------


def test_npz_weights_round_trip_with_jax(tmp_path):
    params = _clstm_params(20, 4, 4)
    jax_params.save_npz(str(tmp_path / "port"), params)
    back = jax_weights.load_npz(str(tmp_path / "port.npz"))
    jax_weights.save_npz(str(tmp_path / "jax.npz"), back)
    again = jax_params.load_npz(str(tmp_path / "jax.npz"))
    for name in params:
        for k in ("w", "b"):
            np.testing.assert_array_equal(back[name][k], params[name][k])
            np.testing.assert_array_equal(again[name][k], params[name][k])
    sd = jax_weights.export_clstm_state_dict(params)
    ported = jax_params.convert_clstm_state_dict(sd)
    theirs = jax_weights.convert_clstm_state_dict(sd)
    for name in params:
        np.testing.assert_array_equal(ported[name]["w"], theirs[name]["w"])


@pytest.mark.parametrize("schedule", [False, True])
def test_train_state_round_trip_and_jax_layout(tmp_path, schedule):
    """A saved train state restores exactly into the port, and the JAX
    package's load_train_state reads it against optax templates."""
    cfg = Config(input_size=4, hidden_size=4, flow_h=8, lr=1e-3,
                 lr_warmup_steps=2 if schedule else 0)
    params = _clstm_params(21, 4, 4)
    seq, flows = _step_batch(22, ch=4)
    model, opt, _ = _port_step(cfg, params, seq, flows, steps=2)
    path = str(tmp_path / "state.npz")
    loop.save_train_state(path, model, opt, step=2, epoch=1, schedule=schedule)

    model2 = loop.trainable_clstm(cfg, params, "cpu")
    opt2 = loop.make_optimizer(cfg, model2)
    assert loop.load_train_state(path, model2, opt2) == (2, 1)
    assert loop.update_count(opt2) == 2
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt2.state[q][key])

    jtx = jax_loop.make_optimizer(JaxConfig(**cfg.__dict__))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jparams, jstate, step, epoch = jax_loop.load_train_state(path, jp, jtx.init(jp))
    assert (step, epoch) == (2, 1)
    np.testing.assert_array_equal(np.asarray(jparams["gates"]["w"]),
                                  model.gates_w.detach().numpy())
    assert int(jax.tree_util.tree_leaves(jstate)[0]) == 2


def test_checkpoint_names_and_pruning_equal_jax(tmp_path):
    cfg = Config()
    assert loop.checkpoint_dir(cfg) == jax_loop.checkpoint_dir(JaxConfig())
    assert loop.checkpoint_name(3, 1200) == jax_loop.checkpoint_name(3, 1200)
    for name in ("CLSTM_00_000010.npz", "CLSTM_01_000030.npz", "CLSTM_00_000020.npz",
                 "epoch_00.npz", "best.npz", "train_state_latest.npz"):
        (tmp_path / name).write_bytes(b"")
    assert loop.latest_checkpoint(str(tmp_path)) == jax_loop.latest_checkpoint(str(tmp_path))
    loop.prune_checkpoints(str(tmp_path), keep=1)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "CLSTM_01_000030.npz", "best.npz", "epoch_00.npz", "train_state_latest.npz"]


# ---- data and the CLI ------------------------------------------------------------


def _artifacts(root, n_frames=8, ch=8, fh=8, fw=16, seed=23):
    rng = np.random.RandomState(seed)
    vids = builtin_split("train_60")[:2]
    for vid in vids:
        (root / vid / "cube_feat").mkdir(parents=True)
        (root / vid / "motion").mkdir(parents=True)
        for i in range(2, 2 + n_frames):
            np.save(root / vid / "cube_feat" / f"{i:06}.npy",
                    rng.rand(6, ch, 7, 7).astype(np.float16))
            np.save(root / vid / "motion" / f"{i:06}.npy",
                    (rng.randn(fh, fw, 2) * 2).astype(np.float32))
    return vids


def test_dataset_and_loader_equal_jax(tmp_path):
    from cp360_tpu.data.dataset import WindowDataset as JaxWindowDataset
    from cp360_tpu.data.dataset import builtin_split as jax_builtin_split

    vids = _artifacts(tmp_path)
    assert builtin_split("train_60") == jax_builtin_split("train_60")
    assert builtin_split("test_25") == jax_builtin_split("test_25")
    ds = WindowDataset(str(tmp_path), None, vids, 5)
    jds = JaxWindowDataset(str(tmp_path), None, vids, 5)
    assert ds.windows == jds.windows and len(ds) == 6
    for a, b in zip(ds.get_batch([0, 4]), jds.get_batch([0, 4])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    loader = PrefetchLoader(ds, batch_size=2, seed=3)
    batches = list(loader.iter_epoch(1, skip_batches=1))
    assert len(loader) == 3 and len(batches) == 2
    assert batches[0][0].shape == (2, 5, 6, 7, 7, 8) and batches[0][1].shape == (2, 5, 8, 16, 2)


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    _artifacts(tmp_path / "art")
    ck = tmp_path / "ck"
    metrics = tmp_path / "m.jsonl"
    argv = ["--input", str(tmp_path / "art"), "--device", "cpu",
            "--metrics-jsonl", str(metrics), "--set", "input_size=8",
            "--set", "hidden_size=8", "--set", "flow_h=8", "--set", "summary_freq=1",
            "--set", "epochs=1", "--set", f"checkpoint_path={ck}", "--set", "lr=1e-3"]
    out = train_temporal.main(argv)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(recs) == 6 and all(np.isfinite(r["loss_avg"]) for r in recs)
    ckdir = ck / os.path.basename(loop.checkpoint_dir(Config()))
    saved = jax_weights.load_npz(str(ckdir / "epoch_00.npz"))  # the JAX reader
    init = jax_params.init_clstm_params(0, 8, 8)
    np.testing.assert_array_equal(saved["gates"]["w"], out["gates"]["w"])
    assert not np.array_equal(saved["gates"]["w"], init["gates"]["w"])

    # --resume continues the full train state: epoch 0 is done, so a run
    # with epochs=2 trains epoch 1 only
    out2 = train_temporal.main(argv[:-6] + ["--set", "epochs=2", "--set", f"checkpoint_path={ck}",
                                            "--set", "lr=1e-3", "--resume"])
    assert "resumed full train state" in capsys.readouterr().out
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [0] * 6 + [1] * 6
    assert not np.array_equal(out2["gates"]["w"], out["gates"]["w"])


def test_cli_needs_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _artifacts(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_temporal.main(["--input", str(tmp_path)])


@pytest.mark.parametrize("argv,match", [
    # what still refuses is what the JAX package refuses, in its words: the
    # published seq_len=5 cannot pipeline, and a mesh needs its ranks
    (["--set", "pipeline_stages=5"], "seq_len=5 cannot pipeline"),
    (["--data-parallel", "2"], r"needs 2 ranks \(one per card\)"),
    (["--set", "mesh_model=2"], r"needs 2 ranks \(one per card\)"),
    (["--set", "checkpoint_backend=tensorstore"], "unknown checkpoint_backend"),
])
def test_unported_training_options_raise(tmp_path, argv, match):
    with pytest.raises(ValueError, match=match):
        train_temporal.main(["--input", str(tmp_path), "--device", "cpu"] + argv)


def test_unported_codec_and_backend_raise_in_their_modules(tmp_path):
    with pytest.raises(ValueError, match="unknown checkpoint_backend"):
        checkpoint.make_checkpointer("tensorstore", str(tmp_path))
    # orbax is the sharded DCP backend now (tests/test_torch_launch.py runs it
    # over two ranks); one process saves and restores exactly
    cfg = Config(input_size=8, hidden_size=8, flow_h=8, compute_dtype="float32", lr=1e-3)
    params = _clstm_params(18, 8, 8)
    seq, flows = _step_batch(19)
    model, opt, _ = _port_step(cfg, params, seq, flows)
    ck = checkpoint.make_checkpointer("orbax", str(tmp_path))
    assert ck.name == "orbax" and not ck.has_state()
    ck.save(model, opt, 7, 1)
    ck.close()
    assert ck.has_state() and (tmp_path / "orbax" / "7" / ".metadata").exists()
    fresh = loop.trainable_clstm(cfg, jax_params.init_clstm_params(3, 8, 8), "cpu")
    fresh_opt = loop.make_optimizer(cfg, fresh)
    assert ck.restore(fresh, fresh_opt) == (7, 1)
    for (n, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), n
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key])
    assert loop.update_count(fresh_opt) == 1
