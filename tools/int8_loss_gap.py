"""How far the training loss of one batch moves when the loader's int8 codec
carries it, in the JAX package on the CPU at full width.

``transfer_codec: int8`` ships a batch's CAM windows as int8 with one f32
scale per frame, face and channel (amax / 127), and its flows as f16.  This
script builds one seeded full-width window (CAM cubes [1, 5, 6, 7, 7, 1000]
f16 as the artifacts store them, flows [1, 5, 480, 960, 2] f32), takes the
loss of the JAX package's train step (ConvLSTM 1000/1000 from the port's
seeded init, f32, flow_h 480) on the batch as the plain loader gives it and
as the int8 loader gives it, and prints the relative gap.  ``chip_smoke.py``
builds the same window (``int8_gap_window``) and holds the port's gap on
the card within this one plus a stated margin.

    JAX_PLATFORMS=cpu python tools/int8_loss_gap.py

Prints one JSON line: both losses and |int8 - none| / |none|.
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def int8_gap_window(seed: int = 13):
    """The seeded full-width window (the same in chip_smoke.py)."""
    rng = np.random.RandomState(seed)
    seq = rng.gamma(0.5, 2.0, (1, 5, 6, 7, 7, 1000)).astype(np.float16)
    flows = (rng.standard_normal((1, 5, 480, 960, 2)) * 2.0).astype(np.float32)
    return seq, flows


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cp360_tpu.config import Config
    from cp360_tpu.ops.quantize import Quantized, quantize_cam_np
    from cp360_tpu.train.loop import make_optimizer, make_train_step
    from cp360_tpu_torch.compat.jax_params import init_clstm_params

    cfg = Config(input_size=1000, hidden_size=1000, flow_h=480, compute_dtype="float32")
    params = init_clstm_params(0, 1000, 1000)
    seq, flows = int8_gap_window()
    opt = make_optimizer(cfg)
    step = make_train_step(cfg, opt)
    losses = {}
    for codec, batch in (("none", (seq, flows)),
                         ("int8", (Quantized(*quantize_cam_np(seq)), flows.astype(np.float16)))):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        _, _, metrics = step(p, opt.init(p), *batch)
        losses[codec] = float(metrics["loss"])
    gap = abs(losses["int8"] - losses["none"]) / abs(losses["none"])
    print(json.dumps({"loss_none": losses["none"], "loss_int8": losses["int8"],
                      "rel_gap": gap}))


if __name__ == "__main__":
    main()
