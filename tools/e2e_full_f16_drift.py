"""How far stage 2 + metrics from the full-geometry golden's f16 feats lie
from the golden's own predictions and aggregate, in the JAX package on the
CPU.

``tests/golden/e2e_full/e2e_golden.npz`` stores the reference's stage-1
feats in float16 (to keep the fixture small), but its predictions and
result were computed from the reference's f32 feats.  Any implementation
that runs stage 2 from the stored feats therefore starts from inputs
rounded to 2^-11 relative; this script measures what that rounding alone
does to the predictions and the aggregate, with the JAX package (ConvLSTM
1000/1000, f32, the metric RNG seeded as the golden's run).  A port run on
the same feats is held within this drift plus a stated margin.

    JAX_PLATFORMS=cpu python tools/e2e_full_f16_drift.py

Prints one JSON line: max |pred - golden pred| (absolute, and relative to
the golden pred's largest value) and |aggregate - golden| per metric.
"""

import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import test_e2e_golden_full as full
    from test_e2e_golden import parse_result_txt, synth_tensor

    from cp360_tpu.cli.test_temporal import main as temporal_main
    from cp360_tpu.compat.torch_weights import convert_clstm_state_dict, save_npz

    g = full.GOLDEN
    keys = [str(k) for k in g["clstm_keys"]]
    shapes = [tuple(int(d) for d in s.split(",") if d) for s in g["clstm_shapes"]]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "root")
        for vid in full.VIDS:
            gtd = os.path.join(root, "Wild360_GT", vid + ".mp4")
            os.makedirs(gtd)
            for fidx, gt in full.golden_group("gt", vid).items():
                np.save(os.path.join(gtd, f"{fidx}.npy"), gt)
            fd = os.path.join(root, "feats", vid, "cube_feat")
            os.makedirs(fd)
            for cnt, feat in full.golden_group("feat", vid).items():
                np.save(os.path.join(fd, f"{cnt}.npy"), feat)
        cfg = os.path.join(root, "config.yaml")
        with open(cfg, "w") as f:
            f.write(full.CONFIG_TMPL.format(root=root, seq=full.SEQ_LEN, cols=full.EQUI_COLS,
                                            rows=full.EQUI_ROWS, classes=full.N_CLASSES))
        save_npz(os.path.join(root, "clstm.npz"), convert_clstm_state_dict(
            {k: synth_tensor(k, s) for k, s in zip(keys, shapes)}))
        cwd = os.getcwd()
        os.chdir(root)
        np.random.seed(full.SEED)
        try:
            temporal_main(["--model", os.path.join(root, "clstm.npz"),
                           "--dir", os.path.join(root, "feats"), "--batch-windows", "4",
                           "--config", cfg])
            with open("feats_result.txt") as f:
                got = parse_result_txt(f.read())
        finally:
            os.chdir(cwd)
        err_abs, err_rel = 0.0, 0.0
        for vid in full.VIDS:
            for fidx, ref in full.golden_group("pred", vid).items():
                ours = np.load(os.path.join(root, "output", "temporal", vid, f"{fidx}.npy"))
                e = float(np.abs(ours - ref).max())
                err_abs = max(err_abs, e)
                err_rel = max(err_rel, e / float(np.abs(ref).max()))
    want = parse_result_txt(str(g["result_txt"]))
    print(json.dumps({"metric": "e2e_full_f16_feats_drift", "backend": "jax cpu f32",
                      "pred_max_abs_err": err_abs, "pred_max_rel_err": err_rel,
                      "aggregate_abs_err": dict(zip(("CC", "AUC", "AUCB"),
                                                    (abs(a - b) for a, b in zip(got, want)))),
                      "aggregate": dict(zip(("CC", "AUC", "AUCB"), got)),
                      "golden": dict(zip(("CC", "AUC", "AUCB"), want))}))


if __name__ == "__main__":
    main()
