"""The port's batchers against fake runtimes (no device work), case for
case the JAX package's ``tests/test_batcher.py``: grouping, pow2 padding,
geometry separation, overflow splitting, failure isolation, error
propagation and drain-on-close.  Byte identity over HTTP is in
``test_torch_service.py``."""
import threading
import time

import numpy as np
import pytest

from sic_tpu_torch.service.batcher import MicroBatcher


def _enc(val: int, stack=(1, 1), tok=32, cb=1):
    """Minimal enc_result carrying a recognizable payload byte."""
    return {
        "stack_shape": stack,
        "feat_shape": (1, 8, 8, 16),
        "token_length": tok,
        "coding_batch": cb,
        "z_bit_stream": bytes([val]),
        "h_bit_stream": b"",
        "img_shape": (32, 32),
        "z_indices_shape": (1, tok),
    }


class FakeRT:
    """Decodes a stream to pixels equal to its first z byte."""

    def __init__(self, fail_on=None, delay_s=0.0):
        self.calls = []
        self.fail_on = fail_on
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def _pix(self, e):
        v = e["z_bit_stream"][0]
        if self.fail_on is not None and v == self.fail_on:
            raise ValueError(f"boom on {v}")
        return np.full((4, 4, 3), v, np.uint8)

    def decode_only(self, output="u8", **e):
        with self.lock:
            self.calls.append(1)
        time.sleep(self.delay_s)
        return self._pix(e)[None]

    def decode_only_batched(self, encs, output="u8", per_stream_networks=False):
        assert per_stream_networks      # grouping must not change bytes
        with self.lock:
            self.calls.append(len(encs))
        time.sleep(self.delay_s)
        return np.stack([self._pix(e) for e in encs])


def test_groups_concurrent_same_geometry_and_pads_pow2():
    rt = FakeRT()
    mb = MicroBatcher(rt, window_ms=250, max_batch=16)
    futs = [mb.submit_decode(_enc(v)) for v in range(5)]
    outs = [f.result(timeout=10) for f in futs]
    for v, o in enumerate(outs):
        assert o.shape == (4, 4, 3) and int(o[0, 0, 0]) == v
    assert mb.batches_dispatched == 1
    assert mb.requests_served == 5
    assert rt.calls == [8]  # 5 padded to the pow2 width
    mb.close()


def test_single_request_uses_latency_path():
    rt = FakeRT()
    mb = MicroBatcher(rt, window_ms=20, max_batch=16)
    out = mb.decode(_enc(7))
    assert int(out[0, 0, 0]) == 7
    assert rt.calls == [1]  # decode_only, not a padded batch
    mb.close()


def test_different_geometries_never_mix():
    rt = FakeRT()
    mb = MicroBatcher(rt, window_ms=200, max_batch=16)
    fa = [mb.submit_decode(_enc(v, stack=(1, 1))) for v in (1, 2)]
    fb = [mb.submit_decode(_enc(v, stack=(2, 2))) for v in (3, 4)]
    fc = mb.submit_decode(_enc(5, cb=8))  # same shape, different coding contract
    vals = [f.result(timeout=10)[0, 0, 0] for f in fa + fb + [fc]]
    assert vals == [1, 2, 3, 4, 5]
    assert mb.batches_dispatched == 3
    mb.close()


def test_overflow_splits_into_full_batches():
    rt = FakeRT()
    mb = MicroBatcher(rt, window_ms=400, max_batch=2)
    futs = [mb.submit_decode(_enc(v)) for v in range(5)]
    vals = sorted(int(f.result(timeout=10)[0, 0, 0]) for f in futs)
    assert vals == [0, 1, 2, 3, 4]
    assert mb.requests_served == 5
    assert sum(rt.calls) >= 5 and max(rt.calls) <= 2
    mb.close()


def test_group_failure_is_isolated_to_the_culprit():
    """One corrupt stream in a group must not fail its co-batched
    neighbors: the batcher retries each lane alone and only the actual
    culprit's future raises."""
    rt = FakeRT(fail_on=1)
    mb = MicroBatcher(rt, window_ms=150, max_batch=16)
    futs = [mb.submit_decode(_enc(v)) for v in (0, 1, 2)]
    assert int(futs[0].result(timeout=10)[0, 0, 0]) == 0
    with pytest.raises(ValueError, match="boom"):
        futs[1].result(timeout=10)
    assert int(futs[2].result(timeout=10)[0, 0, 0]) == 2
    # batched attempt + per-lane retries, all visible in the counters
    assert rt.calls[0] == 4          # the failed pow2-padded group
    assert sorted(rt.calls[1:]) == [1, 1, 1]
    assert mb.requests_served == 2   # only successful lanes count
    # the batcher survives a failed group
    assert int(mb.decode(_enc(3))[0, 0, 0]) == 3
    mb.close()


def test_single_lane_error_still_propagates():
    rt = FakeRT(fail_on=7)
    mb = MicroBatcher(rt, window_ms=10, max_batch=16)
    with pytest.raises(ValueError, match="boom"):
        mb.decode(_enc(7))
    assert rt.calls == [1]  # no pointless retry of a solo lane
    mb.close()


def test_result_count_mismatch_fails_instead_of_hanging():
    """A dispatch that returns the wrong number of results must surface as
    an error on every future, not hang the unmatched waiters forever."""
    from sic_tpu_torch.service.batcher import _GroupQueue

    def bad_dispatch(key, payloads):
        return payloads[:1] if len(payloads) > 1 else payloads

    gq = _GroupQueue(bad_dispatch, window_ms=100, max_batch=16, name="t")
    futs = [gq.submit(("k",), v) for v in (1, 2)]
    # isolation retries each lane alone, where bad_dispatch behaves
    assert [f.result(timeout=10) for f in futs] == [1, 2]
    gq.close()

    def always_bad(key, payloads):
        return []

    gq = _GroupQueue(always_bad, window_ms=50, max_batch=16, name="t2")
    futs = [gq.submit(("k",), v) for v in (1, 2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="results"):
            f.result(timeout=10)
    gq.close()


def test_close_drains_pending():
    rt = FakeRT()
    mb = MicroBatcher(rt, window_ms=5000, max_batch=16)
    futs = [mb.submit_decode(_enc(v)) for v in (1, 2)]
    mb.close()  # must not leave the futures hanging for 5 s
    assert [int(f.result(timeout=1)[0, 0, 0]) for f in futs] == [1, 2]
    with pytest.raises(RuntimeError):
        mb.submit_decode(_enc(9))


class FakeEncRT:
    """Encodes a padded batch to one enc dict per REAL image, tagging each
    with its input's corner pixel so results can't be cross-wired."""

    def __init__(self):
        self.calls = []

    def encode_only_batched(self, x, per_stream_networks=False):
        assert per_stream_networks      # grouping must not change bytes
        x = np.asarray(x)
        self.calls.append(x.shape[0])
        return [{"tag": float(x[i, 0, 0, 0]), "img_shape": x.shape[1:3]}
                for i in range(x.shape[0])]


def test_encode_batcher_groups_by_padded_shape():
    from sic_tpu_torch.service.batcher import EncodeBatcher
    rt = FakeEncRT()
    eb = EncodeBatcher(rt, window_ms=250, max_batch=16)
    import concurrent.futures

    def one(v, hw):
        x = np.full((1, hw, hw, 3), float(v), np.float32)
        return eb.encode(x)

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        futs = [pool.submit(one, v, 8) for v in range(3)] + \
               [pool.submit(one, v, 16) for v in (7, 9)]
        outs = [f.result(timeout=10) for f in futs]
    assert [o["tag"] for o in outs] == [0.0, 1.0, 2.0, 7.0, 9.0]
    # two shape buckets -> two dispatches; 3 reals pad to 4 lanes
    assert sorted(rt.calls) == [2, 4]
    assert eb.batches_dispatched == 2
    eb.close()


def test_encode_batcher_single_passes_through():
    from sic_tpu_torch.service.batcher import EncodeBatcher
    rt = FakeEncRT()
    eb = EncodeBatcher(rt, window_ms=20, max_batch=16)
    out = eb.encode(np.full((1, 8, 8, 3), 5.0, np.float32))
    assert out["tag"] == 5.0 and rt.calls == [1]
    eb.close()


class FakeIndex:
    """search(Q, k) -> scores = first component of each query row."""

    def __init__(self):
        self.calls = []
        self.ids = [f"doc{i}" for i in range(64)]

    def search(self, Q, k):
        Q = np.asarray(Q)
        self.calls.append((Q.shape[0], k))
        scores = np.tile(Q[:, :1], (1, k)).astype(np.float32)
        ids = np.tile(np.arange(k, dtype=np.int64), (Q.shape[0], 1))
        return scores, ids


def test_search_batcher_groups_one_wave_and_slices_topk():
    from sic_tpu_torch.service.batcher import SearchBatcher
    import concurrent.futures
    idx = FakeIndex()
    sb = SearchBatcher(window_ms=250, max_batch=256)

    def one(v, k):
        q = np.full((8,), float(v), np.float32)
        return sb.search(idx, q, k)

    with concurrent.futures.ThreadPoolExecutor(max_workers=5) as pool:
        futs = [pool.submit(one, v, k) for v, k in
                ((1, 3), (2, 5), (3, 2), (4, 5), (5, 4))]
        outs = [f.result(timeout=10) for f in futs]
    for (v, k), (scores, ids) in zip(((1, 3), (2, 5), (3, 2), (4, 5), (5, 4)),
                                     outs):
        assert scores.shape == (k,) and ids.shape == (k,)
        assert float(scores[0]) == float(v)
    # one wave: 5 queries pow2-padded to 8 rows at the max topk of the group
    assert idx.calls == [(8, 5)]
    assert sb.batches_dispatched == 1
    sb.close()


def test_search_batcher_separates_indices():
    from sic_tpu_torch.service.batcher import SearchBatcher
    ia, ib = FakeIndex(), FakeIndex()
    sb = SearchBatcher(window_ms=150, max_batch=256)
    # keys are the index OBJECTS (identity), not id() — address reuse after
    # an index reload must never merge buckets
    fa = sb.submit((ia,), (np.full((4,), 1.0, np.float32), 2))
    fb = sb.submit((ib,), (np.full((4,), 2.0, np.float32), 2))
    sa, _ = fa.result(timeout=10)
    sbb, _ = fb.result(timeout=10)
    assert float(sa[0]) == 1.0 and float(sbb[0]) == 2.0
    assert ia.calls and ib.calls  # each index saw its own wave
    sb.close()
