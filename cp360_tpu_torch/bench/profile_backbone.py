"""Stage-1 backbone device time per stage on one card: the port of
``tools/profile_backbone.py`` (its ``prefix`` and ``pool`` modes).

    python -m cp360_tpu_torch.bench.profile_backbone [batch=16] [n_iters=10]
        [mode=prefix|pool|all] [--device cuda] [--out FILE]

``prefix`` (the line ``backbone_stage_ms``): progressive prefixes of the
resnet50 forward (``models/resnet.py::ResNet.forward``; seeded weights,
bf16) on ``n_iters`` distinct normalized cube batches of ``batch`` frames,
cube-padded and zero-padded; prefix k minus prefix k-1 is stage k (the stem
conv; its batch norm and relu, one epilogue pass, and the stem
pool; layer1..layer4),
``cum_<stage>`` the prefix itself.  ``pool`` (``stem_pool_forms_ms``): the stem's
cube-padded 3x3/s2 max pool at [batch, 6, 112, 112, 64] bf16, as cube pad +
``F.max_pool2d`` (``unfused_ms``) and as the K3 kernel (``fused_rw_ms``),
which must agree bit for bit.  Each time is the median CUDA-event ms of the
back-to-back calls.  The JAX program's ``im2col`` (an XLA lowering of the
stem) and ``int8`` (the TPU's int8 convolutions) modes have no
counterpart.
"""

from __future__ import annotations

import sys

import torch

from cp360_tpu_torch.bench import common
from cp360_tpu_torch.bench.profile_stage1 import component_ms
from cp360_tpu_torch.models import layers
from cp360_tpu_torch.models.layers import pad_faces
from cp360_tpu_torch.ops import cube_pad as cp_ops

METRIC = "backbone_stage_ms"
STAGES = ("stem_conv", "bn_relu_pool", "layer1", "layer2", "layer3", "layer4")


def upto(model, x: torch.Tensor, n_stages: int) -> torch.Tensor:
    """The first ``n_stages`` + 1 entries of :data:`STAGES` of the ResNet
    forward on face-flattened [N*6, H, W, 3] input (as ``ResNet.forward``
    runs them)."""
    cd = model.compute_dtype
    xp = pad_faces(x.to(cd), 3, model.use_cube_pad)
    if n_stages == 0:
        return model.conv1(xp, 2, cd)  # the stem conv alone
    out = layers.conv_bn(xp, model.conv1, model.bn1, 2, cd, act="relu")
    if model.use_cube_pad:
        out = cp_ops.cube_pad_max_pool_3x3s2(out.reshape(-1, 6, *out.shape[1:]))
        out = out.reshape(-1, *out.shape[2:])
    else:
        out = layers.max_pool(pad_faces(out, 1, False), 3, 2)
    for stage in model.stages[:n_stages - 1]:
        for block in stage:
            out = block(out, cd)
    return out


def profile_prefixes(models: dict, batch: int, n_iters: int, *, device: torch.device,
                     cube_dim: int = 224) -> dict:
    """``models``: {"cubepad": backbone, "zeropad": the same weights with
    zero padding}.  Returns the ``backbone_stage_ms`` line."""
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    xs = [torch.randn((batch * 6, cube_dim, cube_dim, 3), generator=gen, device=device)
          .to(torch.bfloat16) for _ in range(n_iters)]
    out = {}
    for tag, model in models.items():
        prev, stages = 0.0, {}
        for k, name in enumerate(STAGES):
            t = component_ms(lambda x, k=k: upto(model, x, k), xs, device)
            stages[name] = round(t - prev, 3)
            stages[f"cum_{name}"] = round(t, 3)
            prev = t
        out[tag] = stages
    return {"metric": METRIC, "batch": batch, "n_iters": n_iters, **out}


def profile_pool(batch: int, n_iters: int, *, device: torch.device, h: int = 112,
                 c: int = 64) -> dict:
    """The ``stem_pool_forms_ms`` line."""
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    xs = [torch.randn((batch, 6, h, h, c), generator=gen, device=device).to(torch.bfloat16)
          for _ in range(n_iters)]

    def unfused(x):
        return layers.max_pool(cp_ops.cube_pad(x, 1).reshape(-1, h + 2, h + 2, c), 3, 2)

    def fused(x):
        return cp_ops.cube_pad_max_pool_3x3s2(x)

    with torch.no_grad():
        a, b = unfused(xs[0]), fused(xs[0]).reshape(-1, h // 2, h // 2, c)
    if not torch.equal(a, b):
        raise AssertionError(f"the pool forms differ by {(a.float() - b.float()).abs().max()}")
    return {"metric": "stem_pool_forms_ms", "batch": batch,
            "unfused_ms": round(component_ms(unfused, xs, device), 3),
            "fused_rw_ms": round(component_ms(fused, xs, device), 3)}


def main(argv=None) -> int:
    from cp360_tpu_torch.compat import jax_params

    args = common.parse_args(__doc__, argv, ("batch", "n_iters", "mode"))
    batch, n_iters = int(args.batch or 16), int(args.n_iters or 10)
    mode = args.mode or "prefix"
    if mode not in ("prefix", "pool", "all"):
        sys.exit(f"mode {mode!r}: the port has prefix, pool and all (im2col and int8 are "
                 "an XLA lowering and the TPU's int8 convolutions)")

    def run(device):
        lines = []
        if mode in ("prefix", "all"):
            params = jax_params.init_resnet_params(0, "resnet50")
            models = {tag: jax_params.backbone_from_params(params, "resnet50", cp,
                                                           torch.bfloat16, device)
                      for tag, cp in (("cubepad", True), ("zeropad", False))}
            with torch.no_grad():
                lines.append(profile_prefixes(models, batch, n_iters, device=device))
        if mode in ("pool", "all"):
            lines.append(profile_pool(batch, n_iters, device=device))
        return lines

    return common.run(METRIC if mode != "pool" else "stem_pool_forms_ms", args, run)


if __name__ == "__main__":
    raise SystemExit(main())
