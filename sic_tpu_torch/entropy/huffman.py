"""Per-QP Huffman codec (numpy and bytes).

The port's copy of the JAX package's ``entropy/huffman.py``, the
counterpart of the reference's auxiliary Huffman path
(reference: src/entropy/entropy_models.py:381-493) — wired into
``CompressionModel`` there but never exercised by the shipped pipeline;
provided for capability parity.  Bitstream layout matches: a leading "1"
sentinel bit, then the concatenated codes, big-endian packed.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Sequence

import numpy as np


def build_huffman_table(prob: Sequence[float]) -> List[str]:
    """Symbol index -> code string.  Heap-based; ties broken by insertion
    order like the reference's argpartition loop (stable for its use)."""
    n = len(prob)
    if n == 1:
        return ["0"]
    heap = [(float(p), i, i) for i, p in enumerate(prob)]  # (prob, tiebreak, node)
    heapq.heapify(heap)
    # nodes: leaves 0..n-1; internal nodes appended as (left, right)
    children: Dict[int, tuple] = {}
    next_id = n
    while len(heap) > 1:
        p1, _, a = heapq.heappop(heap)
        p2, _, b = heapq.heappop(heap)
        children[next_id] = (a, b)
        heapq.heappush(heap, (p1 + p2, next_id, next_id))
        next_id += 1
    codes = [""] * n

    def assign(node: int, code: str):
        if node < n:
            codes[node] = code or "0"
            return
        left, right = children[node]
        assign(left, code + "0")
        assign(right, code + "1")

    assign(heap[0][2], "")
    return codes


class HuffmanCodecOneQP:
    def __init__(self, prob: Sequence[float]):
        self.table = build_huffman_table(prob)
        # decode trie as dict prefix -> symbol
        self._decode = {c: i for i, c in enumerate(self.table)}
        self._maxlen = max(len(c) for c in self.table)

    def compress(self, x) -> Dict[str, bytes]:
        """x: integer array of symbol indexes."""
        idxs = np.asarray(x).reshape(-1)
        x_str = "1" + "".join(self.table[int(i)] for i in idxs)
        x_int = int(x_str, 2)
        num_bytes = (x_int.bit_length() + 7) // 8
        return {"bit_stream": x_int.to_bytes(num_bytes, "big")}

    def decompress(self, bit_stream: bytes) -> Dict[str, np.ndarray]:
        bits = bin(int.from_bytes(bit_stream, "big"))[3:]  # drop '0b1'
        out = []
        i, n = 0, len(bits)
        while i < n:
            for l in range(1, self._maxlen + 1):
                sym = self._decode.get(bits[i:i + l])
                if sym is not None:
                    out.append(sym)
                    i += l
                    break
            else:
                raise ValueError("invalid huffman stream")
        return {"index": np.asarray(out, np.int64)}


class HuffmanCodec:
    """QP-indexed codec registry (reference: entropy_models.py:478-493)."""

    def __init__(self):
        self.codec_list: Dict[int, HuffmanCodecOneQP] = {}

    def load_probs(self, probs: Dict[int, Sequence[float]]):
        for qp, p in probs.items():
            self.codec_list[qp] = HuffmanCodecOneQP(np.asarray(p, np.float64))

    def compress(self, x, q_index: int):
        return self.codec_list[q_index].compress(x)

    def decompress(self, bit_stream: bytes, q_index: int):
        return self.codec_list[q_index].decompress(bit_stream)
