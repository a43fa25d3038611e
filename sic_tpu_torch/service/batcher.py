"""Cross-request micro-batching for the serving paths.

The service keeps one runtime in process; this module also shares its
device work: concurrent requests whose streams (or padded images) have one
geometry are grouped and run through the runtime's batched entry points
(``decode_only_batched`` / ``encode_only_batched``), so the autoregressive
entropy chain of a decode, or of an encode, runs once per group instead of
once per request.  The port of the JAX package's ``service/batcher.py``.

Policy: the first request landing in an empty bucket opens a ``window_ms``
collection window; the group dispatches at ``max_batch`` or at the end of
the window, whichever comes first.  Groups are padded to the next power of
two by repeating the last payload, which bounds the set of batch shapes
the runtime meets to {1, 2, 4, ..., max_batch}.  The coding-batch contract
(``models/bottleneck.py``) makes the padded replay bit-identical for the
real lanes, and the networks (the encoder, the pixel decoder) run one
stream at a time (``per_stream_networks``), because the card's and the
CPU's batched passes round differently from single ones: grouping never
changes bytes.  A group that fails is retried lane by lane, so one corrupt
stream fails alone.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

__all__ = ["MicroBatcher", "EncodeBatcher", "SearchBatcher"]


def _pow2_pad(items: list) -> list:
    width = 1
    while width < len(items):
        width *= 2
    return items + [items[-1]] * (width - len(items))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _GroupQueue:
    """Window-grouping core: collects ``(key, payload)`` submissions into
    per-key groups and hands each group to ``dispatch(key, payloads)``
    (one result per payload) on one worker thread, or, with
    ``dispatch_workers > 1``, on a pool of that many threads so that one
    group's upload overlaps another's device work (the search waves; the
    codec batchers keep 1, since their dispatches share stateful host
    coders)."""

    def __init__(self, dispatch: Callable[[tuple, List[Any]], List[Any]],
                 window_ms: float, max_batch: int, name: str,
                 dispatch_workers: int = 1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._dispatch_fn = dispatch
        self.window_s = float(window_ms) / 1000.0
        self.max_batch = int(max_batch)
        self._cv = threading.Condition()
        # key -> (monotonic time the bucket opened, [(payload, future), ...])
        self._buckets: Dict[tuple, Tuple[float, List[tuple]]] = {}
        self._closed = False
        self.batches_dispatched = 0
        self.requests_served = 0
        self._pool = None
        if dispatch_workers > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=dispatch_workers,
                                            thread_name_prefix=f"{name}-d")
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, key: tuple, payload: Any) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if key not in self._buckets:
                self._buckets[key] = (time.monotonic(), [])
            self._buckets[key][1].append((payload, fut))
            self._cv.notify_all()
        return fut

    def close(self):
        """Drain pending groups, then stop the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    def _loop(self):
        while True:
            with self._cv:
                while not self._buckets and not self._closed:
                    self._cv.wait()
                if not self._buckets and self._closed:
                    return
                # the earliest-opened bucket first (FIFO across geometries)
                key = min(self._buckets, key=lambda k: self._buckets[k][0])
                t0, items = self._buckets[key]
                deadline = t0 + self.window_s
                now = time.monotonic()
                if (len(items) < self.max_batch and now < deadline
                        and not self._closed):
                    self._cv.wait(deadline - now)
                    continue
                if len(items) > self.max_batch:
                    # the overflow stays queued as a bucket already due
                    self._buckets[key] = (now - self.window_s,
                                          items[self.max_batch:])
                    items = items[:self.max_batch]
                else:
                    del self._buckets[key]
            if self._pool is not None:
                self._pool.submit(self._run_group, key, items)
            else:
                self._run_group(key, items)

    def _served(self, n: int) -> None:
        with self._cv:
            self.batches_dispatched += 1
            self.requests_served += n

    def _run_group(self, key: tuple, items: List[tuple]):
        try:
            outs = self._dispatch_fn(key, [p for p, _ in items])
            if len(outs) != len(items):
                # unmatched futures would wait forever: fail them instead
                raise RuntimeError(f"dispatch returned {len(outs)} results "
                                   f"for {len(items)} payloads")
            self._served(len(items))
            for (_p, fut), out in zip(items, outs):
                fut.set_result(out)
        except Exception as exc:
            if len(items) == 1:
                if not items[0][1].done():
                    items[0][1].set_exception(exc)
                return
            # one malformed payload (a corrupt .c2df whose header geometry
            # matched the bucket) must not fail the requests grouped with
            # it: retry each lane alone, so only the culprits fail
            for p, fut in items:
                if fut.done():
                    continue
                try:
                    outs = self._dispatch_fn(key, [p])
                    if len(outs) != 1:
                        raise RuntimeError(f"dispatch returned {len(outs)} "
                                           "results for 1 payload")
                except Exception as lane_exc:
                    fut.set_exception(lane_exc)
                else:
                    self._served(1)
                    fut.set_result(outs[0])


class MicroBatcher(_GroupQueue):
    """Groups concurrent ``decode(enc_result)`` calls into batched decodes;
    ``batches_dispatched`` / ``requests_served`` expose the grouping."""

    def __init__(self, rt, window_ms: float = 8.0, max_batch: int = 16):
        self.rt = rt
        super().__init__(self._decode_group, window_ms, max_batch,
                         name="sic-decode-batcher")

    @staticmethod
    def _bucket_key(enc: Dict[str, Any], output: str) -> tuple:
        """Streams that may share one batched decode (the decompress CLI's
        grouping; ``decode_only_batched`` checks the same)."""
        return (tuple(enc["stack_shape"]),
                tuple(int(s) for s in enc["feat_shape"]),
                int(enc["token_length"]),
                enc.get("coding_batch"),
                output)

    def _decode_group(self, key: tuple, encs: List[dict]) -> List[np.ndarray]:
        output = key[-1]
        if len(encs) == 1:
            out = _host(self.rt.decode_only(**encs[0], output=output))
        else:
            out = _host(self.rt.decode_only_batched(
                _pow2_pad(encs), output=output, per_stream_networks=True))
        return [out[i] for i in range(len(encs))]

    def submit_decode(self, enc: Dict[str, Any], output: str = "u8") -> Future:
        """Enqueue one stream; resolves to (H, W, 3) pixels on the host."""
        return self.submit(self._bucket_key(enc, output), dict(enc))

    def decode(self, enc: Dict[str, Any], output: str = "u8") -> np.ndarray:
        return self.submit_decode(enc, output).result()


class EncodeBatcher(_GroupQueue):
    """Groups concurrent ``encode(x_padded)`` calls (one image each,
    replicate-padded to the tile grid) into batched encodes, bucketed by
    the padded shape as the compress CLI buckets its images."""

    def __init__(self, rt, window_ms: float = 8.0, max_batch: int = 16):
        self.rt = rt
        super().__init__(self._encode_group, window_ms, max_batch,
                         name="sic-encode-batcher")

    def _encode_group(self, key: tuple, xs: List[Any]) -> List[dict]:
        if len(xs) == 1:
            return self.rt.encode_only_batched(xs[0], per_stream_networks=True)
        x = np.concatenate([_host(x) for x in _pow2_pad(list(xs))], axis=0)
        return self.rt.encode_only_batched(x, per_stream_networks=True)[:len(xs)]

    def encode(self, x_padded) -> dict:
        """x_padded: (1, H, W, 3) in [-1, 1] on the host, H and W multiples
        of the tile; returns that image's enc_result dict."""
        if x_padded.ndim != 4 or x_padded.shape[0] != 1:
            raise ValueError(f"one (1, H, W, 3) image, got {tuple(x_padded.shape)}")
        key = (int(x_padded.shape[1]), int(x_padded.shape[2]))
        return self.submit(key, x_padded).result()


class SearchBatcher(_GroupQueue):
    """Groups concurrent queries against one index into one scoring wave:
    a (B, D) x (D, N) product and one top k instead of B single-row
    searches."""

    def __init__(self, window_ms: float = 4.0, max_batch: int = 256,
                 dispatch_workers: int = 2):
        super().__init__(self._search_group, window_ms, max_batch,
                         name="sic-search-batcher",
                         dispatch_workers=dispatch_workers)

    def _search_group(self, key: tuple, payloads: List[tuple]) -> List[tuple]:
        index = key[0]
        k = max(p[1] for p in payloads)
        qs = [np.asarray(p[0], np.float32).reshape(-1) for p in payloads]
        scores, ids = index.search(np.stack(_pow2_pad(qs)), k=k)
        return [(scores[i, :p[1]], ids[i, :p[1]])
                for i, p in enumerate(payloads)]

    def search(self, index, q, topk: int):
        """One query vector against ``index``; returns (scores, ids) rows
        of shape (topk,), as ``VectorIndex.search``'s rows.

        The bucket key is the index object itself, not its ``id()``: the
        service replaces an index when its files change, and a freed
        address can be reused, so an ``id()`` key could merge queries
        against a dead index with queries against its replacement."""
        return self.submit((index,), (q, int(topk))).result()
