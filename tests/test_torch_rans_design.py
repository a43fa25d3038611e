"""The arithmetic of the rANS kernels' Hopper design, on the CPU.

The card's kernels (``csrc/rans_decode.cu``, ``csrc/rans_encode.cu``) run
only there, so the new arithmetic they rest on is emulated here, step for
step, and held to what it replaces:

* the encode divides by reciprocal: for freq >= 2, shift = ceil(log2 freq),
  rcp = ceil(2^(shift + 31) / freq) and x' = x + start +
  (umulhi(x, rcp) >> (shift - 1)) * (65536 - freq).  Held to x // freq and
  x % freq for every freq in [1, 65535] (freq = 1 is a shift operation),
  at every boundary of the renormalised range [0, freq << 15) and at
  seeded samples in between (uint64 numpy).  A shift operation
  x' = (x << n) | val runs the same formula with rcp = 2^32 - 1, rshift 0,
  cmpl = 2^n - 1 and bias = val + cmpl, exact for every x >= 1;
* the encode's producers expand each chunk of 64 positions, walked from
  the row's end, into coding operations laid out by a block scan (two
  warp scans and the first warp's total), and one chain applies them: a
  chunk that starts in [L, 2^31) and whose bytes fit takes at most two
  emits an operation and the one formula; any other takes the emit loop
  with the cap check.  Its bytes and states equal
  ``rans_encode_plane_plain``'s and the native encoder's, overflow
  included;
* the decode's slot search: 32 lanes hold 4 entries each of the packed row
  (``ops/rans_tables.py``: stride 104, entries past the row's size above
  every cum), one ballot per entry marks those <= cum, and the popcounts
  less one (row[0] is 0) give the slot, whose start and next entry come
  from the row.  Held to the earlier kernel's binary search and the C++
  decoder's linear scan on every row of the gaussian tables and every
  cum;
* the decode's schedule: indexes read a window of 32 at a time into a
  list of live positions, popped a position ahead of the one decoding,
  symbols written a window at a time (zeros for a window with none).
  Held to the live positions, in order, and to every position of the row
  written once, on rows whose first windows hold one or two live
  positions, on runs of skips and with the slow path taken anywhere.
"""
import numpy as np
import pytest
import torch

from sic_tpu_torch import ops
from sic_tpu_torch.entropy import EntropyCoder, build_gaussian_tables
from sic_tpu_torch.ops import rans_encode as renc
from sic_tpu_torch.ops.rans_tables import packed_tables
from test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

M32 = 0xFFFFFFFF
RAW_TAG = 0x80000000

CHUNK = 64          # positions of an encode chunk: one a producer thread
BIG = 0xFFFFFFFF    # a masked entry: no cum reaches it


# -- the encode's division by reciprocal ---------------------------------------

# ceil(log2 f) = (f - 1).bit_length() = 32 - __clz(f - 1), for f >= 1
_CEIL_LOG2 = np.array([max(f - 1, 0).bit_length() for f in range(1 << 16)],
                      dtype=np.uint64)


def recip_constants(freq: np.ndarray):
    """The kernel's symbol_op() constants for freq >= 2 (uint64 arrays)."""
    freq = freq.astype(np.uint64)
    shift = _CEIL_LOG2[freq.astype(np.int64)]
    rcp = ((np.uint64(1) << (shift + np.uint64(31))) + freq - np.uint64(1)) // freq
    return rcp, shift - np.uint64(1), np.uint64(1 << 16) - freq


def recip_update(x, start, freq):
    """x' of a coded symbol as the chain computes it (uint64 emulation of
    the uint32 arithmetic); freq = 1 as the shift operation it becomes."""
    x = x.astype(np.uint64)
    start = np.asarray(start, dtype=np.uint64)
    out = np.empty_like(x)
    one = freq == 1
    out[one] = shift_update(x[one], start[one], 16)
    f = freq[~one]
    rcp, rshift, cmpl = recip_constants(f)
    xs = x[~one]
    q = ((xs * rcp) >> np.uint64(32)) >> rshift
    out[~one] = (xs + start[~one] + q * cmpl) & np.uint64(M32)
    return out


def shift_update(x, val, n):
    """x' = (x << n) | val through the reciprocal formula: rcp = 2^32 - 1,
    rshift = 0, cmpl = 2^n - 1, bias = val + cmpl."""
    cmpl = np.uint64((1 << n) - 1)
    q = (x * np.uint64(M32)) >> np.uint64(32)
    return (x + val + cmpl + q * cmpl) & np.uint64(M32)


def test_reciprocal_constants_fit_the_operation():
    freq = np.arange(2, 1 << 16, dtype=np.uint64)
    rcp, rshift, cmpl = recip_constants(freq)
    # rcp < 2^32 - 1, the shift operations' marker
    assert (rcp < np.uint64(M32)).all() and (rcp >= np.uint64(1 << 31)).all()
    assert (rshift <= 15).all() and (cmpl >= 1).all() and (cmpl <= 65534).all()


@pytest.mark.parametrize("lo,hi", [(1, 8192), (8192, 24576), (24576, 40960),
                                   (40960, 65536)])
def test_reciprocal_division_matches_divide(lo, hi):
    """Every freq in [lo, hi): x' equal to ((x // freq) << 16) + x % freq +
    start at the range's boundaries (0, 1, freq - 1, freq, freq + 1, the
    last quotients' edges, (freq << 15) - 1) and 48 seeded samples."""
    rng = np.random.default_rng(lo)
    freq = np.arange(lo, hi, dtype=np.uint64)
    top = freq << np.uint64(15)
    edges = [np.zeros_like(freq), np.ones_like(freq), freq - 1, freq, freq + 1,
             2 * freq - 1, 2 * freq, top - freq - 1, top - freq, top - 2,
             top - 1, top // 2, (top // 2) // freq * freq]
    samples = (rng.random((48, freq.size)) * top.astype(np.float64)).astype(np.uint64)
    x = np.concatenate([np.stack(edges), samples]) % top
    f = np.broadcast_to(freq, x.shape).reshape(-1)
    x = x.reshape(-1)
    start = rng.integers(0, 1 << 16, x.size).astype(np.uint64) % (
        np.uint64(1 << 16) - f + np.uint64(1))
    if lo == 1:   # freq = 1 meets x = 0 only at a state no stream reaches
        keep = (f != 1) | (x >= 1)
        x, f, start = x[keep], f[keep], start[keep]
    got = recip_update(x, start, f)
    want = ((x // f) << np.uint64(16)) + x % f + start
    np.testing.assert_array_equal(got, want)
    assert (want < np.uint64(1 << 31)).all()


@pytest.mark.parametrize("n", [2, 16])
def test_shift_operation_through_the_formula(n):
    """(x << n) | val for every val < 2^n at x in [1, 2^(31 - n)): the
    renormalised range of a 2-bit raw chunk (n = 2) and of freq = 1."""
    rng = np.random.default_rng(n)
    top = 1 << (31 - n)
    x = np.concatenate([np.arange(1, 4097), top - np.arange(1, 4097),
                        rng.integers(1, top, 1 << 16)]).astype(np.uint64)
    val = rng.integers(0, 1 << n, x.size).astype(np.uint64)
    val[:4] = [0, 1, (1 << n) - 2, (1 << n) - 1]
    np.testing.assert_array_equal(shift_update(x, val, n),
                                  (x << np.uint64(n)) | val)


# -- the encode's operation list and chain --------------------------------------

def shift_op(val, n):
    cmpl = (1 << n) - 1
    return (1 << (31 - n), M32, val + cmpl, cmpl << 16)


def symbol_op(start, freq):
    if freq == 0:
        return shift_op(start, 2)
    if freq == 1:
        return shift_op(start, 16)
    shift = (freq - 1).bit_length()
    rcp = ((1 << (shift + 31)) + freq - 1) // freq
    return (freq << 15, rcp, start, ((65536 - freq) << 16) | (shift - 1))


def position_ops(sv, ci, cdf, sizes, offsets):
    """One producer thread's expansion of its position (an empty list for
    a skipped one)."""
    if ci < 0 or ci >= cdf.shape[0]:
        return []
    max_value = int(sizes[ci]) - 2
    value = int(sv) - int(offsets[ci])
    escape, raw_val = False, 0
    if value < 0:
        raw_val, value, escape = (-2 * value - 1) & M32, max_value, True
    elif value >= max_value:
        raw_val, value, escape = (2 * (value - max_value)) & M32, max_value, True
    ops_ = []
    if escape:
        n_bypass = (raw_val.bit_length() + 1) // 2
        ops_ += [shift_op((raw_val >> (2 * j)) & 3, 2)
                 for j in range(n_bypass - 1, -1, -1)]
        ops_.append(shift_op(n_bypass % 3, 2))
        ops_ += [shift_op(3, 2)] * (n_bypass // 3)
    lo, hi = int(cdf[ci, value]), int(cdf[ci, value + 1])
    ops_.append(symbol_op(lo & 0xFFFF, (hi - lo) & 0xFFFF))
    return ops_


def block_scan(counts):
    """Exclusive offsets and total of 64 per-thread counts as the kernel
    forms them: a Hillis-Steele shuffle scan in each warp, then warp 1
    adds warp 0's total."""
    incl = torch.tensor(counts, dtype=torch.int64).reshape(2, 32)
    for d in (1, 2, 4, 8, 16):
        up = torch.roll(incl, d, dims=1)
        up[:, :d] = 0
        incl = incl + up
    incl[1] += incl[0, 31]
    excl = incl.reshape(-1) - torch.tensor(counts, dtype=torch.int64)
    return excl.tolist(), int(incl[1, 31])


def chunk_ops(sym_row, idx_row, k, cdf, sizes, offsets):
    """Chunk k's operations in the layout the producers write."""
    npos = sym_row.numel()
    per_thread = []
    for t in range(CHUNK):
        p = npos - 1 - k * CHUNK - t
        per_thread.append(position_ops(int(sym_row[p]), int(idx_row[p]), cdf, sizes,
                                       offsets) if p >= 0 else [])
    excl, total = block_scan([len(o) for o in per_thread])
    slot = [None] * total
    for at, ops_ in zip(excl, per_thread):
        slot[at:at + len(ops_)] = ops_
    return slot


def chain(ops_, x, pos, out, cap):
    """The chain's walk of one chunk; returns (x, pos, overflow)."""
    if 1 << 23 <= x < 1 << 31 and pos + 2 * len(ops_) <= cap:
        for x_max, rcp, bias, w in ops_:       # at most two emits, one formula
            a = x >> 8
            e1, e2 = x >= x_max, a >= x_max
            if e1:
                out[pos] = x & 0xFF
            if e2:
                out[pos + 1] = a & 0xFF
            pos += e1 + e2
            xr = x >> 16 if e2 else a if e1 else x
            q = ((xr * rcp) >> 32) >> (w & 31)
            x = (xr + bias + q * (w >> 16)) & M32
        return x, pos, False
    for x_max, rcp, bias, w in ops_:           # the emit loop, any state
        while x >= x_max:
            if pos >= cap:
                return x, pos, True
            out[pos] = x & 0xFF
            pos += 1
            x >>= 8
        cmpl = w >> 16
        if rcp == M32:
            x = ((x << cmpl.bit_length()) | (bias - cmpl)) & M32
        else:
            x = (x + bias + (((x * rcp) >> 32) >> (w & 31)) * cmpl) & M32
    return x, pos, False


def encode_plane_emulated(sym, idx, words, state, cdf, sizes, offsets):
    """rans_encode_plane's arguments and results, through the emulated
    producers and chain."""
    S, npos = idx.shape
    buf = words.view(torch.uint8).view(S, -1)
    cap = buf.shape[1]
    new_state = state.clone()
    for s in range(S):
        x, pos, ov = (int(v) for v in state[s, :3])
        if ov:
            continue
        out = {}
        for k in range(-(-npos // CHUNK)):
            x, pos, ov = chain(chunk_ops(sym[s], idx[s], k, cdf, sizes, offsets),
                               x, pos, out, cap)
            if ov:
                break
        for p, b in out.items():
            buf[s, p] = b
        new_state[s] = torch.tensor([x, pos, int(ov), 0])
    return words, new_state


def _encode_case(S, npos, seed):
    """Four planes: 5% escapes up to the int16 clamp, runs of up to 200
    skipped positions besides 10% single skips."""
    rng = np.random.default_rng(seed)
    t = build_gaussian_tables("gaussian")
    planes = []
    for _ in range(4):
        idx = rng.integers(0, t.levels, (S, npos)).astype(np.int16)
        skip = rng.random((S, npos)) < 0.1
        for s, i in zip(*np.nonzero(rng.random((S, npos)) < 0.01)):
            skip[s, i:i + rng.integers(1, 201)] = True
        idx[skip] = -1
        sym = rng.integers(-6, 7, (S, npos)).astype(np.int16)
        esc = rng.random((S, npos)) < 0.05
        sym[esc] = rng.integers(-30000, 30001, int(esc.sum())).astype(np.int16)
        sym[idx < 0] = 0
        planes.append((sym, idx))
    tables = [torch.from_numpy(a.astype(np.int32))
              for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    return t, planes, tables


def _run(fn, planes, tables, S, nwords, x0=None):
    words = torch.zeros((S, nwords), dtype=torch.int32)
    st = renc.initial_state(S)
    if x0 is not None:
        st[:, 0] = x0
    for sym, idx in reversed(planes):
        words, st = fn(torch.from_numpy(sym.astype(np.int32)),
                       torch.from_numpy(idx.astype(np.int32)), words, st, *tables)
    return words.numpy(), st.numpy()


@pytest.mark.parametrize("S,npos", [(4, 1024), (3, 100)])
def test_operation_list_gives_the_plain_and_native_bytes(S, npos):
    from sic_tpu_torch.models.bottleneck import worst_case_bytes
    t, planes, tables = _encode_case(S, npos, S * npos)
    nwords = -(-worst_case_bytes(4 * npos) // 4)
    e_words, e_st = _run(encode_plane_emulated, planes, tables, S, nwords)
    p_words, p_st = _run(ops.rans_encode_plane_plain, planes, tables, S, nwords)
    np.testing.assert_array_equal(e_st, p_st)
    parts = renc.finalize_streams(e_words, e_st, S)
    assert parts == renc.finalize_streams(p_words, p_st, S)
    for s in range(S):
        coder = EntropyCoder(1)
        g = coder.add_cdf(t.quantized_cdf, t.cdf_length, t.offset)
        coder.reset()
        for sym, idx in planes:
            coder.encode_with_indexes(sym[s], idx[s], g)
        coder.flush()
        assert parts[s] == coder.get_encoded_stream()[1:]


@pytest.mark.parametrize("nwords", [9, 60])
def test_operation_list_overflows_where_the_plain_version_does(nwords):
    """A buffer that fills inside a chunk: the same bytes, cursor, state
    and flag as the plain version."""
    S, npos = 3, 100
    _t, planes, tables = _encode_case(S, npos, nwords)
    e_words, e_st = _run(encode_plane_emulated, planes, tables, S, nwords)
    p_words, p_st = _run(ops.rans_encode_plane_plain, planes, tables, S, nwords)
    np.testing.assert_array_equal(e_st, p_st)
    np.testing.assert_array_equal(e_words, p_words)
    assert (e_st[:, 2] == 1).any()


@pytest.mark.parametrize("x0", [0, 1, 77, (1 << 23) - 1])
def test_operation_list_from_a_state_below_l(x0):
    """A state no stream reaches (x < L; x = 0 meets the shift operations'
    one inexact point): the emit loop and the plain shift take it until x
    enters [L, 2^31), and the bytes and states still equal the plain
    version's."""
    from sic_tpu_torch.models.bottleneck import worst_case_bytes
    S, npos = 3, 100
    _t, planes, tables = _encode_case(S, npos, 5)
    nwords = -(-worst_case_bytes(4 * npos) // 4)
    e_words, e_st = _run(encode_plane_emulated, planes, tables, S, nwords, x0)
    p_words, p_st = _run(ops.rans_encode_plane_plain, planes, tables, S, nwords, x0)
    np.testing.assert_array_equal(e_st, p_st)
    np.testing.assert_array_equal(e_words, p_words)


# -- the decode's warp search ---------------------------------------------------

def warp_search(block, stride, ncdf, c, cum):
    """Slot, start and frequency for row c at every cum, as the warp finds
    them.  ``block`` is the packed table (``ops/rans_tables.py``)."""
    rows = block[:ncdf * stride].view(ncdf, stride).long() & M32
    lane = torch.arange(32)
    lane_in = 4 * lane < stride
    flat = torch.cat([rows.reshape(-1), torch.full((128,), BIG)])
    v = flat[c * stride + 4 * lane[:, None] + torch.arange(4)]   # (32, 4)
    hit = (v[None] <= cum[:, None, None]) & lane_in[None, :, None]
    ballots = hit.sum(1)                                 # popc per entry j
    s = ballots.sum(-1) - 1
    start = rows[c][s]
    freq = rows[c][s + 1] - start
    return s, start, freq


def binary_search(row, size, cum):
    """The earlier kernel's upper bound over row[1 .. size-1]."""
    first = torch.ones_like(cum)
    count = torch.full_like(cum, size - 1)
    while bool((count > 0).any()):
        step = count >> 1
        probe = row[(first + step).clamp(max=row.numel() - 1)]
        go = (count > 0) & (probe <= cum)
        first = torch.where(go, first + step + 1, first)
        count = torch.where(go, count - step - 1, torch.where(count > 0, step, count))
    return first - 1


def linear_scan(row, size, cum):
    """sic_rans.cc decode(): s = 0; while s + 1 < size and cdf[s+1] <= cum."""
    s = torch.zeros_like(cum)
    more = torch.ones_like(cum, dtype=torch.bool)
    for k in range(1, size):
        more = more & (row[k] <= cum)
        s = s + more.long()
    return s


def test_warp_search_matches_binary_search_and_linear_scan():
    t = build_gaussian_tables("gaussian")
    cdf, sizes, offsets = (torch.from_numpy(a.astype(np.int32))
                           for a in (t.quantized_cdf, t.cdf_length, t.offset))
    block, stride = packed_tables(cdf, sizes, offsets)
    ncdf = cdf.shape[0]
    assert stride == 104 and block.numel() % 4 == 0
    cum = torch.arange(1 << 16, dtype=torch.int64)
    for c in range(ncdf):
        row, size = cdf[c].long(), int(sizes[c])
        s, start, freq = warp_search(block, stride, ncdf, c, cum)
        assert torch.equal(s, binary_search(row, size, cum)), c
        assert torch.equal(s, linear_scan(row, size, cum)), c
        assert torch.equal(start, row[s]) and torch.equal(freq, row[s + 1] - row[s]), c


def test_packed_table_refuses_what_the_kernels_cannot_take():
    t = build_gaussian_tables("gaussian")
    cdf, sizes, offsets = (torch.from_numpy(a.astype(np.int32))
                           for a in (t.quantized_cdf, t.cdf_length, t.offset))
    for c, k, v in ((5, 3, None), (9, 0, 1), (40, None, 65535)):
        bad = cdf.clone()
        k = int(sizes[c]) - 1 if k is None else k
        bad[c, k] = bad[c, k - 1] if v is None else v
        with pytest.raises(ValueError, match=f"row {c} "):
            packed_tables(bad, sizes, offsets)
    short = sizes.clone()
    short[7] = 1
    with pytest.raises(ValueError, match="row 7 "):
        packed_tables(cdf, short, offsets)


# -- the decode's schedule of live positions -------------------------------------

class _Windows:
    """The kernel's list of live positions (refill() and pop() in
    rans_decode.cu): a window of 32 indexes at a time, an empty window
    written out as zeros at once, npos once the row is done."""

    def __init__(self, live, out):
        self.live, self.out, self.npos = live, out, len(live)
        self.gw, self.gi, self.gn, self.list = -32, 0, 0, []

    def refill(self):
        while self.gi == self.gn:
            self.gw += 32
            if self.gw >= self.npos:
                self.gw, self.gi, self.gn = self.npos, 0, 0
                return
            qs = [q for q in range(self.gw, self.gw + 32) if q < self.npos]
            self.list = [q for q in qs if self.live[q]]
            self.gi, self.gn = 0, len(self.list)
            if self.gn == 0:
                for q in qs:
                    self.out[q] = 0

    def pop(self):
        if self.gi < self.gn:
            self.gi += 1
            return self.list[self.gi - 1]
        return self.npos


def decode_schedule(live, rare=frozenset()):
    """(positions decoded, in order; the row as written) by kernel 3's loop,
    step for step: position p decodes to p + 1, a position never written
    stays -1.  ``rare`` holds the positions whose step takes the slow path
    for a reason the schedule does not see (an escape, a long refill, a
    new stream segment)."""
    npos = len(live)
    out = [-1] * npos
    w = _Windows(live, out)
    decoded, mine = [], {}      # mine: lane -> symbol of the open window
    w.refill()
    p = w.pop()
    if p < npos:
        if w.gi == w.gn:
            w.refill()
        pn = w.pop()
        if w.gi == w.gn:
            w.refill()
        while True:
            more = pn < npos
            pnn = w.pop()
            decoded.append(p)
            mine[p & 31] = p + 1
            flush = not more or ((pn ^ p) >> 5) != 0
            if not (p in rare or flush or w.gi == w.gn):
                p, pn = pn, pnn
                continue
            if flush:
                for lane in range(32):
                    q = (p & ~31) + lane
                    if q < npos:
                        out[q] = mine.get(lane, 0)
                mine = {}
            if w.gi == w.gn:
                w.refill()
            if not more:
                break
            p, pn = pn, pnn
    return decoded, out


def _first_windows(name, live):
    """Rows whose first windows of 32 hold one or two live positions."""
    cols, upto = {"two_then_a_gap": ([0, 1], 64),
                  "one_in_each_of_two": ([5, 40], 64),
                  "two_after_empty_windows": ([100, 101], 160),
                  "two_in_the_row": ([31, 32], None),
                  "one_in_the_row": ([300], None)}[name]
    live[:upto] = False
    live[cols] = True


@pytest.mark.parametrize("name", ["two_then_a_gap", "one_in_each_of_two",
                                  "two_after_empty_windows", "two_in_the_row",
                                  "one_in_the_row", "runs", "none", "all"])
@pytest.mark.parametrize("npos", [512, 333])
def test_decode_schedule_visits_every_live_position(name, npos):
    rng = np.random.default_rng(npos + len(name))
    for trial in range(20):
        live = rng.random(npos) >= 0.1
        if name == "runs":
            for i in np.nonzero(rng.random(npos) < 0.02)[0]:
                live[i:i + rng.integers(1, 100)] = False
        elif name == "none":
            live[:] = False
        elif name == "all":
            live[:] = True
        else:
            _first_windows(name, live)
        rare = set(np.nonzero(rng.random(npos) < 0.1 * (trial % 3))[0].tolist())
        decoded, out = decode_schedule(live.tolist(), rare)
        want = np.nonzero(live)[0]
        assert decoded == want.tolist(), (name, trial)
        np.testing.assert_array_equal(
            out, np.where(live, np.arange(npos) + 1, 0), err_msg=f"{name} {trial}")
