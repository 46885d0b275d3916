"""A worker of the port's multi-process tests (tests/test_torch_launch.py).

    python tests/torch_dist_worker.py hello
    python tests/torch_dist_worker.py step IN.npz OUT_DIR MESH_DATA MESH_MODEL

Each process joins the job through ``maybe_init_distributed`` on the CPU
(gloo), from the rendezvous environment the launcher or the test sets.
``hello`` all-reduces its rank and prints ``DIST_OK``; ``step`` runs one
train step of the port on the (data x model) grid over the batch in
IN.npz and writes this rank's loss and the whole gradients (gathered over
the model group) to OUT_DIR/rank{r}.npz.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hello() -> None:
    import torch
    import torch.distributed as dist

    from cp360_tpu_torch.parallel import mesh

    assert mesh.maybe_init_distributed("cpu") is True
    assert mesh.maybe_init_distributed("cpu") is True  # idempotent
    t = torch.tensor([float(mesh.process_index() + 1)])
    dist.all_reduce(t)
    print(f"DIST_OK pid={mesh.process_index()} n={mesh.process_count()} sum={int(t.item())}",
          flush=True)


def step(inp: str, out_dir: str, n_data: int, n_model: int) -> None:
    import torch

    from cp360_tpu_torch.config import Config
    from cp360_tpu_torch.parallel import mesh
    from cp360_tpu_torch.train import loop

    torch.set_num_threads(1)
    mesh.maybe_init_distributed("cpu")
    with np.load(inp) as f:
        data = dict(f)
    ch = int(data["ch"])
    params = {name: {k: data[f"{name}/{k}"] for k in ("w", "b")}
              for name in ("conv1", "conv2", "gates")}
    cfg = Config(input_size=ch, hidden_size=ch, flow_h=int(data["flow_h"]),
                 compute_dtype="float32", lr=1e-3, mesh_data=n_data, mesh_model=n_model)
    grid = mesh.grid_from_config(cfg)
    model = loop.trainable_clstm(cfg, params, "cpu", grid)
    opt = loop.make_optimizer(cfg, model)
    train_step = loop.make_train_step(cfg, model, opt, grid)
    seq, flows = mesh.shard_batch(grid, (data["seq"], data["flows"]))
    metrics = train_step(torch.from_numpy(seq), torch.from_numpy(flows))
    out = {k: v.numpy() for k, v in metrics.items()}
    for name in ("conv1", "conv2", "gates"):
        for key in ("w", "b"):
            g = getattr(model, f"{name}_{key}").grad
            if model.model_group is not None:
                g = mesh.all_gather_cat(g, model.model_group, dim=-1)
            out[f"grad/{name}/{key}"] = g.numpy()
    np.savez(os.path.join(out_dir, f"rank{mesh.process_index()}.npz"), **out)
    print(f"STEP_OK pid={mesh.process_index()} loss={float(metrics['loss']):.9g}", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "hello":
        hello()
    else:
        step(sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))
