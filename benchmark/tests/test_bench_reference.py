"""The plain reference agrees with the port at tiny sizes on the CPU: the
sampling maps and the cube-pad map exactly, the backbone, the CAM, the
ConvLSTM window and the training loss with its gradients in float32."""

import numpy as np
import pytest
import torch

from benchmark.lib import port, weights
from benchmark.reference import geometry
from benchmark.reference import model as ref

TINY = {"arch": "resnet50", "base_width": 8, "num_classes": 16,
        "config": {"cube_dim": 64, "input_size": 16, "hidden_size": 16, "seq_len": 5,
                   "compute_dtype": "float32", "flow_h": 32}}
CPU = torch.device("cpu")


def test_geometry_maps_equal_the_ports():
    from cp360_tpu_torch.geometry.equi_cube import build_equi2cube_maps
    from cp360_tpu_torch.ops.cube_pad import build_cube_pad_index_map
    from cp360_tpu_torch.ops.resample import build_cube2equi_matrix

    for fw, h in ((224, 960), (64, 128)):
        for a, b in zip(geometry.equi2cube_maps(fw, h, 2 * h), build_equi2cube_maps(fw, h, 2 * h)):
            np.testing.assert_array_equal(a, b)
    for w in (7, 2):
        np.testing.assert_allclose(geometry.cube2equi_matrix(w), build_cube2equi_matrix(w),
                                   atol=1e-7)
    for h, p in ((7, 1), (56, 1), (224, 3), (4, 2)):
        np.testing.assert_array_equal(geometry.cube_pad_map(h, p),
                                      build_cube_pad_index_map(h, h, p))


def test_backbone_and_cam_equal_the_ports_in_f32():
    from cp360_tpu_torch.models.cam import cam_forward

    w = weights.for_config(TINY, 5, CPU, clstm=False)["bb"]
    model = port.resnet(TINY, w)
    faces = torch.rand((2, 6, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    mean, std = torch.tensor(ref.IMAGENET_MEAN), torch.tensor(ref.IMAGENET_STD)
    got, _ = cam_forward(model, (faces - mean) / std)
    want = ref.cam_scores(w, ref.resnet_features(w, faces))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_window_equals_the_ports_in_f32():
    from cp360_tpu_torch.pipelines.temporal import window_infer

    w = weights.for_config(TINY, 6, CPU, backbone=False)["cl"]
    cell = port.clstm(TINY, w)
    windows = torch.rand((3, 5, 6, 2, 2, 16), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(window_infer(cell, windows), ref.window_saliency(w, windows),
                               rtol=1e-5, atol=1e-5)


def test_train_loss_and_gradients_equal_the_ports_in_f32():
    from cp360_tpu_torch.train import loop

    cfg = port.program_config(TINY)
    w = weights.for_config(TINY, 7, CPU, backbone=False)["cl"]
    cell = port.clstm(TINY, {n: {k: t.clone() for k, t in d.items()} for n, d in w.items()},
                      trainable=True)
    g = torch.Generator().manual_seed(2)
    seq = torch.rand((2, 5, 6, 2, 2, 16), generator=g)
    flows = torch.randn((2, 5, 32, 64, 2), generator=g) * 3
    loss, _ = loop.make_loss_fn(cfg, cell)(seq, flows)
    loss.backward()
    leaves = {n: {k: t.clone().requires_grad_(True) for k, t in d.items()}
              for n, d in w.items()}
    want = ref.train_loss(leaves, seq, flows, l_s=cfg.l_s, l_t=cfg.l_t, l_m=cfg.l_m,
                          mm_th=cfg.mm_th, flow_h=cfg.flow_h)
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    for n in leaves:
        for k in ("w", "b"):
            torch.testing.assert_close(getattr(cell, f"{n}_{k}").grad, leaves[n][k].grad,
                                       rtol=1e-4, atol=1e-4 * float(leaves[n][k].grad.abs().max()))


def test_adam_equals_torch():
    g = torch.Generator().manual_seed(3)
    p = torch.randn(50, generator=g)
    q = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    mine = ref.Adam([p], 1e-3)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        q.grad = grad.clone()
        opt.step()
        mine.step([grad])
    torch.testing.assert_close(p, q.detach(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_weights_are_made_from_the_seed(seed):
    a = weights.for_config(TINY, seed, CPU)
    b = weights.for_config(TINY, seed, CPU)
    c = weights.for_config(TINY, seed + 2, CPU)
    assert torch.equal(a["bb"]["stages"][3][2]["conv2"], b["bb"]["stages"][3][2]["conv2"])
    assert torch.equal(a["cl"]["gates"]["w"], b["cl"]["gates"]["w"])
    assert not torch.equal(a["cl"]["gates"]["w"], c["cl"]["gates"]["w"])
