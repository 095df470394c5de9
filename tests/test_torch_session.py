"""The port's bucket registry and TorchSession against the JAX package's
BucketSpec / JaxSession contract, on the CPU."""
import numpy as np
import pytest
import torch

from rapiddoc_tpu.engine import buckets as jb
from rapiddoc_tpu.engine.session import pad_image_to as jax_pad_image_to
from rapiddoc_tpu_torch.engine import buckets as tb
from rapiddoc_tpu_torch.engine.session import TorchSession, resolve_device


@pytest.mark.parametrize("name", ["DET_BUCKETS", "REC_BUCKETS"])
def test_bucket_decisions_match_jax(name):
    ours, theirs = getattr(tb, name), getattr(jb, name)
    assert ours.max_batch() == theirs.max_batch()
    for n in range(1, 300, 7):
        assert ours.bucket_batch(n) == theirs.bucket_batch(n)
    rng = np.random.default_rng(0)
    shapes = [tuple(int(v) for v in rng.integers(10, 2000, 2)) for _ in range(200)]
    for h, w in shapes:
        assert ours.bucket_hw(h, w) == theirs.bucket_hw(h, w)
    assert tb.group_by_bucket(shapes, ours) == jb.group_by_bucket(shapes, theirs)


def test_pad_image_to_matches_jax():
    img = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    np.testing.assert_array_equal(tb.pad_image_to(img, 8, 9), jax_pad_image_to(img, 8, 9))


class _Double(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, x):
        return {"y": x * self.scale, "n": (x > 0).sum(dim=(1, 2, 3))}


def test_session_pads_chunks_and_slices():
    spec = tb.BucketSpec(heights=(4,), widths=(4,), batch_sizes=(2, 4))
    sess = TorchSession(lambda m, x: m(x), _Double(), spec, device="cpu",
                        dtype=torch.float32, preproc=lambda x: x.float() / 2)
    batch = np.arange(7 * 4 * 4 * 1, dtype=np.uint8).reshape(7, 4, 4, 1)
    out = sess(batch)  # 7 > max bucket 4: chunks of 4 + 3 (padded to 4)
    np.testing.assert_allclose(out["y"], batch.astype(np.float32))
    assert out["y"].dtype == np.float32 and out["n"].shape == (7,)
    rows = TorchSession.fetch_rows([sess.dispatch(batch[:3])])
    assert len(rows) == 3 and rows[2]["y"].shape == (4, 4, 1)
    st = sess.stats.as_dict()
    assert st["items"] == 10 and st["padded_items"] == 12 and st["calls"] == 3
    assert st["fetches"] == 2


def test_session_keeps_weights_in_policy_dtype():
    spec = tb.BucketSpec(heights=(4,), widths=(4,), batch_sizes=(1,))
    sess = TorchSession(lambda m, x: m(x), _Double(), spec, device="cpu")
    assert sess.module.scale.dtype == torch.bfloat16
    out = sess(np.ones((1, 4, 4, 1), np.uint8))
    assert out["y"].dtype == np.float32  # float outputs come back as fp32


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_compiles_count_new_bucket_signatures_only():
    """A bucket signature's first dispatch is the port's compile: counted
    once, its cost recorded under the session's name, every call counted."""
    from rapiddoc_tpu_torch.engine import flops

    spec = tb.BucketSpec(heights=(4,), widths=(4, 8), batch_sizes=(2, 4))
    sess = TorchSession(lambda m, x: m(x), _Double(), spec, name="compiles_probe",
                        device="cpu", dtype=torch.float32, preproc=lambda x: x.float())
    flops.reset()
    for n, w in ((1, 4), (2, 4)):  # one bucket: (2, 4, 4, 1)
        sess(np.zeros((n, 4, w, 1), np.uint8))
    assert sess.stats.compiles == 1
    sess(np.zeros((3, 4, 4, 1), np.uint8))  # batch bucket 4
    sess(np.zeros((1, 4, 8, 1), np.uint8))  # another width
    assert sess.stats.compiles == 3
    sess(np.zeros((7, 4, 4, 1), np.uint8))  # chunks of 4 and 3 -> 4: no new bucket
    assert sess.stats.compiles == 3 and sess.stats.calls == 6
    rep = flops.cost_report()["compiles_probe"]
    assert rep["calls"] == 6 and rep["analyzed"] == 3 and rep["flops"] == 0.0
    assert rep["bytes"] > 0
    flops.reset()


def test_report_keys_equal_jax():
    """SessionStats, session_stats_report, measure_wire_bandwidth and
    transfer_split_report carry the JAX package's keys; without a card the
    wire constants and the estimate are None."""
    from rapiddoc_tpu.engine import session as js
    from rapiddoc_tpu_torch.engine import session as ts

    assert list(ts.SessionStats().as_dict()) == list(js.SessionStats().as_dict())
    spec = tb.BucketSpec(heights=(4,), widths=(4,), batch_sizes=(1,))
    sess = TorchSession(lambda m, x: m(x), _Double(), spec, name="keys_probe", device="cpu",
                        dtype=torch.float32)
    sess(np.ones((1, 4, 4, 1), np.uint8))
    jsess = js.JaxSession(lambda p, x: x, {}, jb.BucketSpec(heights=(4,), widths=(4,),
                                                            batch_sizes=(1,)), name="keys_probe")
    assert ts.session_stats_report()["keys_probe"] == sess.stats.as_dict()
    assert list(js.session_stats_report()["keys_probe"]) == list(sess.stats.as_dict())
    want = js.transfer_split_report()["keys_probe"]
    got = ts.transfer_split_report()["keys_probe"]
    assert list(got) == list(want)
    assert got["bytes_in"] == 16 and got["fetches"] == 1
    wire = ts.measure_wire_bandwidth()
    assert list(wire) == list(js.measure_wire_bandwidth())
    if not torch.cuda.is_available():
        assert set(wire.values()) == {None} and got["transfer_ms_est"] is None
    js._ALL_SESSIONS.remove(jsess)
