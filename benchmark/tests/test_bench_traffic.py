"""Each traffic mix is made from the seed: the same seed gives the same
inputs, another seed others."""

import tempfile
from pathlib import Path

import numpy as np

from benchmark.drivers import stream, train
from tiny import tiny_run


def _made(cell, make, seed):
    run = tiny_run(cell, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        run.tmp = Path(tmp)
        out = make(run)
        if isinstance(out, str):  # a directory of artifacts
            return {p.relative_to(out).as_posix(): p.read_bytes()
                    for p in sorted(Path(out).rglob("*.npy"))}
        if isinstance(out, list) and isinstance(out[0], str):  # clip files
            return [stream.decode_frames(p, {0, 19})[19].tobytes() for p in out]
        return out


def test_stream_clips():
    a, b = _made("r50-stream", stream.write_clips, 7), _made("r50-stream", stream.write_clips, 7)
    assert a == b and a != _made("r50-stream", stream.write_clips, 8)


def test_train_artifacts():
    a = _made("r50-train", train.write_artifacts, 2 ** 31 + 3)
    assert len(a) == 2 * 3 * 9 and a == _made("r50-train", train.write_artifacts, 2 ** 31 + 3)
    assert a != _made("r50-train", train.write_artifacts, 4)


def test_train_reference_order_is_the_loaders():
    from cp360_tpu_torch.data.dataset import PrefetchLoader, WindowDataset

    run = tiny_run("r50-train", seed=2 ** 31 + 77)
    with tempfile.TemporaryDirectory() as tmp:
        run.tmp = Path(tmp)
        root = train.write_artifacts(run)
        st = train.State()
        st.root = root
        ds = WindowDataset(root, None, train.videos(run), 5)
        loader = PrefetchLoader(ds, batch_size=4, seed=train.loader_seed(run))
        got = [b for _, b in zip(range(3), loader)]
        want = list(train.reference_batches(run, st))
        for (gs, gf), (ws, wf) in zip(got, want):
            np.testing.assert_array_equal(gs.astype(np.float32), ws.numpy())
            np.testing.assert_array_equal(gf, wf.numpy())
