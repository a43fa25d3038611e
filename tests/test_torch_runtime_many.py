"""The runtime's concurrent entry points on the CPU: ``decode_only_many``,
``round_trip_pipelined`` and ``encode_decode_many`` on the tiny spec's
golden params (``tests/fixtures/golden/params.npz``), three heldout images.

- Each equals its serial counterpart bit for bit: ``decode_only`` a stream,
  ``decode_only_batched(encode_only_batched(b))`` a batch (the JAX twins:
  ``test_codec_e2e.py::test_concurrent_decode_matches_sequential``,
  ``test_batched_decode.py::test_round_trip_pipelined_matches_sequential``),
  ``encode_decode`` an image (bytes, bpp dict and x_hat).
- Against the JAX runtime on the same params and images: stream bytes and
  bpp dicts equal, x_hat within 1e-3.
- Four threads through ``device_entropy="device"`` (the rANS kernels' plain
  versions here) decode as the serial host coder does; sixteen threads
  looking up, pruning and filling the kernels' packed-table cache get the
  tables a single thread packs, and their kernel-launch counts add up; the
  encode-path counts add up under two threads.
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.data import load_image

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"
X_TOL = 1e-3      # end to end, fp32: the two frameworks sum in other orders


@pytest.fixture(scope="module")
def rt():
    runtime = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(),
                           device="cpu", stream_part=4)
    yield runtime
    runtime.close()


@pytest.fixture(scope="module")
def images():
    return [load_image(HELDOUT / f"val{i}.png")[None] for i in range(3)]


@pytest.fixture(scope="module")
def encs(rt, images):
    return [rt.encode_only(x) for x in images]


@pytest.fixture(scope="module")
def serial(rt, encs):
    return [rt.decode_only(**e) for e in encs]


def test_decode_only_many_equals_serial_decodes(rt, encs, serial):
    many = rt.decode_only_many(encs, workers=4)
    assert len(many) == len(encs)
    for a, b in zip(many, serial):
        assert torch.equal(a, b)


def test_decode_only_many_through_the_plain_kernels(rt, encs, serial):
    """``device_entropy="device"`` on four threads: the rANS decode
    kernel's plain version on every h stream, the same pixels as the
    serial host-coder decodes."""
    rt.device_entropy = "device"
    try:
        probe = {}
        rt.decode_only(**encs[0], probe=probe)
        assert probe["h_path"] == "device"
        many = rt.decode_only_many(encs * 2, workers=4)
    finally:
        rt.device_entropy = "auto"
    for a, b in zip(many, serial * 2):
        assert torch.equal(a, b)


def _hammer(work, threads=16):
    """Run ``work(i)`` on ``threads`` threads (more than this host's cores)
    started together, with the interpreter switching threads as often as
    it can; returns what the calls raised."""
    errors = []
    start = threading.Barrier(threads)

    def run(i):
        try:
            start.wait(timeout=60)
            work(i)
        except Exception as e:       # noqa: BLE001 - returned to the test
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    return errors


def test_packed_table_cache_under_threads():
    """Sixteen threads pack, look up and (as tables die) prune the kernels'
    table cache at once; every call returns what a lone ``_pack`` gives."""
    from sic_tpu_torch.entropy import build_gaussian_tables
    from sic_tpu_torch.ops import rans_tables
    t = build_gaussian_tables("gaussian")
    base = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in (t.quantized_cdf, t.cdf_length, t.offset)]
    want, want_stride = rans_tables._pack(*base)

    def work(i):
        for j in range(40):
            # a fresh table every other call: inserts, and prunes as the
            # earlier ones die
            srcs = base if j % 2 else [a.clone() for a in base]
            block, stride = rans_tables.packed_tables(*srcs)
            assert stride == want_stride and torch.equal(block, want), (i, j)

    errors = _hammer(work)
    assert not errors, errors[:3]


def test_launch_counts_add_up_under_threads():
    """Every launch a wrapper counts from many threads at once is kept."""
    from sic_tpu_torch.ops import cuda_build

    def wrapper():
        pass

    wrapper.launches = 0

    def work(i):
        for _ in range(2000):
            cuda_build.count_launch(wrapper)

    assert not _hammer(work)
    assert wrapper.launches == 16 * 2000


def test_round_trip_pipelined_equals_the_sequential_pair(rt, images):
    batches = [np.concatenate(images[:2]), np.concatenate(images[1:])]
    outs = rt.round_trip_pipelined(batches)
    assert len(outs) == 2
    for b, out in zip(batches, outs):
        ref = rt.decode_only_batched(rt.encode_only_batched(b))
        assert torch.equal(out, ref)


def test_encode_decode_many_equals_encode_decode(rt, images):
    before = dict(rt.encode_path_counts)
    many = rt.encode_decode_many(images, workers=2)
    counted = {k: rt.encode_path_counts[k] - before[k] for k in before}
    assert counted == {"device": 0, "host": len(images)}
    for x, (x_hat, bpp, enc) in zip(images, many):
        x_ref, bpp_ref, enc_ref = rt.encode_decode(x, x.shape[1:3])
        assert enc["z_bit_stream"] == enc_ref["z_bit_stream"]
        assert enc["h_bit_stream"] == enc_ref["h_bit_stream"]
        assert bpp == bpp_ref
        assert torch.equal(x_hat, x_ref)


def test_encode_decode_many_matches_jax(rt, images):
    """The JAX runtime on the same params and images: equal streams and
    bpp dicts, x_hat within 1e-3."""
    import jax.numpy as jnp
    from sic_tpu.config import tiny_spec as jtiny
    from sic_tpu.models import CodecRuntime as JRuntime
    from fixtures.golden.generate import load_params
    jrt = JRuntime(jtiny(), load_params(GOLDEN / "params.npz"), stream_part=4)
    want = jrt.encode_decode_many([jnp.asarray(x) for x in images])
    got = rt.encode_decode_many(images)
    for (x_hat, bpp, enc), (jx, jbpp, jenc) in zip(got, want):
        assert enc["z_bit_stream"] == jenc["z_bit_stream"]
        assert enc["h_bit_stream"] == jenc["h_bit_stream"]
        assert bpp == jbpp
        np.testing.assert_allclose(x_hat.numpy(), np.asarray(jx), rtol=0, atol=X_TOL)
