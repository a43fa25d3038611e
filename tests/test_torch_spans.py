"""The port's trace-only spans on the CPU, and the benchmark's readers of them.

- ``timed_stage`` enters a ``record_function`` range only while a profiler
  runs (on any thread), costs a flag read otherwise, and changes no
  output of the runtime;
- the entropy chain's spans (``h_rans.step``, ``h_rans.fetch``,
  ``h_rans.code``) on the calling thread, inside the JAX runtime's
  stages, in ``decode_only_batched`` and the host path of
  ``encode_only_batched``;
- compress's per-image spans (``clip.embed`` > ``clip.preprocess``,
  ``clip.zstd``, ``c2df.pack``, ``c2df.unpack``), the sampler's
  (``maskgit.generate``, ``maskgit.step``, ``maskgit.sync``) and the U-ViT
  generator's (``maskgit.uvit.down``, ``.mid``, ``.up`` > ``.skip``);
- ``profile_trace`` records a span entered on a pool thread, with the call
  number it carries;
- six readers under ``portbench/metrics/`` on a hand-built trace in the
  Chrome format the harness reads: four of host spans, and two of the
  device time launched inside spans (``maskgit.step``,
  ``maskgit.uvit.skip``).
"""
import json
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sic_tpu_torch import config as tcfg
from sic_tpu_torch.cli._common import load_runtime
from sic_tpu_torch.data import load_image
from sic_tpu_torch.utils import profiling
from sic_tpu_torch.utils.profiling import StageTimer, timed_stage, tracing

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden"
HELDOUT = ROOT / "artifacts_r05" / "heldout"


def _ranges(prof, tmp_path):
    """The trace's ``record_function`` ranges as (name, tid, start, end)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation" and "dur" in e]


def _named(ranges, name, tid=None):
    return [r for r in ranges if r[0] == name and (tid is None or r[1] == tid)]


def _inside(inner, outers):
    """``inner`` lies within one of ``outers`` on the same thread."""
    return any(o[1] == inner[1] and o[2] <= inner[2] and inner[3] <= o[3]
               for o in outers)


def _traced(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof, tmp_path)


@pytest.fixture(scope="module")
def rt():
    runtime = load_runtime(str(GOLDEN / "params.npz"), tcfg.tiny_spec(),
                           device="cpu", stream_part=4)
    yield runtime
    runtime.close()


@pytest.fixture(scope="module")
def images():
    return np.concatenate([load_image(HELDOUT / f"val{i}.png")[None] for i in range(2)])


@pytest.fixture(scope="module")
def encs(rt, images):
    return rt.encode_only_batched(images)


# -- the gate ---------------------------------------------------------------------

def test_tracing_flag_reads_true_on_pool_threads_while_a_profiler_runs():
    assert not tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        with ThreadPoolExecutor(1) as pool:
            assert pool.submit(tracing).result()
        assert tracing()
    assert not tracing()


def test_untraced_stage_enters_no_record_function(rt, encs, images, tmp_path, monkeypatch):
    """With no profiler, timed_stage never enters a range (both ways of
    entering one raise here) and the timer still records; the runtime's
    outputs are bit-equal with tracing on and off."""
    traced_dec, _ = _traced(lambda: rt.decode_only_batched(encs), tmp_path)
    traced_enc, _ = _traced(lambda: rt.encode_only_batched(images), tmp_path)

    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._autograd, "_record_function_with_args_enter", refuse)
    timer = StageTimer()
    with timed_stage(timer, "h_rans", 3), timed_stage(None, "h_rans.code"):
        pass
    assert set(timer.stages) == {"h_rans"}
    dec = rt.decode_only_batched(encs)
    enc = rt.encode_only_batched(images)
    assert torch.equal(dec, traced_dec)
    assert [(e["h_bit_stream"], e["z_bit_stream"]) for e in enc] == \
        [(e["h_bit_stream"], e["z_bit_stream"]) for e in traced_enc]


# -- the entropy chain ------------------------------------------------------------

def test_decode_only_batched_spans_each_step_of_the_chain(rt, encs, tmp_path):
    _, ranges = _traced(lambda: rt.decode_only_batched(encs), tmp_path)
    tid = threading.get_native_id()
    h_rans = _named(ranges, "h_rans", tid)
    steps = _named(ranges, "h_rans.step", tid)
    assert len(h_rans) == 1 and len(steps) == 4
    assert all(_inside(s, h_rans) for s in steps)
    for name in ("h_rans.fetch", "h_rans.code"):
        spans = _named(ranges, name, tid)
        assert all(_inside(s, steps) for s in spans), name
        for step in steps:
            assert any(_inside(s, [step]) for s in spans), (name, step)


def test_encode_only_batched_spans_the_host_path(rt, images, tmp_path):
    probe = {}
    _, ranges = _traced(lambda: rt.encode_only_batched(images, probe=probe), tmp_path)
    assert probe["h_path"] == "host"
    tid = threading.get_native_id()
    fetch = _named(ranges, "h_rans.fetch", tid)
    code = _named(ranges, "h_rans.code", tid)
    assert fetch and all(_inside(s, _named(ranges, "fetch", tid)) for s in fetch)
    assert code and all(_inside(s, _named(ranges, "h_rans", tid)) for s in code)


def test_spans_keep_the_jax_stage_names_in_the_timer(rt, encs, images):
    """The new spans are trace-only: a StageTimer sees the JAX runtime's
    stages and no other."""
    for call, want in ((lambda t: rt.decode_only_batched(encs, t),
                        {"z_rans", "h_rans", "decode_device"}),
                       (lambda t: rt.encode_only_batched(images, timer=t),
                        {"encode_device", "fetch", "h_rans", "z_rans"})):
        with profile(activities=[ProfilerActivity.CPU]):
            timer = StageTimer()
            call(timer)
        assert set(timer.stages) == want


# -- compress's per-image work and the container ----------------------------------

def test_clip_zstd_and_container_spans(images, tmp_path):
    from sic_tpu_torch.container import pack_c2df, unpack_c2df
    from sic_tpu_torch.retrieval import ClipCodec, CLIPSpec
    clip = ClipCodec(spec=CLIPSpec(vision_width=128, vision_layers=2, vision_heads=2,
                                   embed_dim=64), device="cpu", seed=0)

    def work():
        vec = clip.image_to_unit_vec(images[0])
        stream, meta = clip.quantize_u8_and_compress(vec)
        blob = pack_c2df({"clip_stream": stream}, {"clip_meta": meta})
        return unpack_c2df(blob)

    (enc, _header), ranges = _traced(work, tmp_path)
    assert enc["clip_stream"]
    tid = threading.get_native_id()
    embed = _named(ranges, "clip.embed", tid)
    pre = _named(ranges, "clip.preprocess", tid)
    assert len(embed) == 1 and len(pre) == 1 and _inside(pre[0], embed)
    for name in ("clip.zstd", "c2df.pack", "c2df.unpack"):
        assert len(_named(ranges, name, tid)) == 1, name
    _, ranges = _traced(lambda: clip.images_to_unit_vecs(np.zeros((2, 224, 224, 3))),
                        tmp_path)
    assert len(_named(ranges, "clip.embed", tid)) == 1
    assert not _named(ranges, "clip.preprocess")


# -- the sampler ------------------------------------------------------------------

def test_generate_spans_each_step_and_its_sync(tmp_path):
    from sic_tpu_torch.models.maskgit import MaskGITGenerator, MaskGITSpec, generate
    torch.manual_seed(0)
    gen = MaskGITGenerator(MaskGITSpec(codebook_size=64, condition_num_classes=10,
                                       image_seq_len=8, hidden=96, num_layers=2,
                                       num_heads=2)).eval()
    steps = 5
    run = (lambda: generate(gen, torch.Generator().manual_seed(1),
                            torch.tensor([0, 3]), num_sample_steps=steps))
    ids, ranges = _traced(run, tmp_path)
    assert torch.equal(ids, run())
    tid = threading.get_native_id()
    outer = _named(ranges, "maskgit.generate", tid)
    step = _named(ranges, "maskgit.step", tid)
    sync = _named(ranges, "maskgit.sync", tid)
    assert (len(outer), len(step), len(sync)) == (1, steps, steps)
    assert all(_inside(s, outer) for s in step)
    assert all(_inside(s, step) for s in sync)


def test_uvit_generator_spans_its_stages_and_skips(tmp_path):
    """Each pass of the U-ViT generator spans its in, mid and out blocks
    (``maskgit.uvit.down``, ``.mid``, ``.up``) inside the sampler's step,
    and each out block's concatenation and skip projection
    (``maskgit.uvit.skip``) inside ``.up``."""
    from sic_tpu_torch.models.maskgit import generate
    from sic_tpu_torch.models.maskgit_uvit import UViTGenerator, UViTSpec
    torch.manual_seed(0)
    gen = UViTGenerator(UViTSpec(codebook_size=64, condition_num_classes=10,
                                 image_seq_len=8, hidden=64, num_layers=4,
                                 num_heads=2, intermediate_size=128)).eval()
    steps = 3
    run = (lambda: generate(gen, torch.Generator().manual_seed(1), torch.tensor([0, 3]),
                            num_sample_steps=steps, guidance_decay="power-cosine"))
    ids, ranges = _traced(run, tmp_path)
    assert torch.equal(ids, run())
    tid = threading.get_native_id()
    step = _named(ranges, "maskgit.step", tid)
    passes = 2 * steps
    for name in ("maskgit.uvit.down", "maskgit.uvit.mid", "maskgit.uvit.up"):
        spans = _named(ranges, name, tid)
        assert len(spans) == passes and all(_inside(s, step) for s in spans), name
    skip = _named(ranges, "maskgit.uvit.skip", tid)
    assert len(skip) == 2 * passes
    assert all(_inside(s, _named(ranges, "maskgit.uvit.up", tid)) for s in skip)


# -- profile_trace ----------------------------------------------------------------

def test_profile_trace_records_a_span_on_a_pool_thread(tmp_path):
    """The operator's trace holds a span entered on a worker thread, and
    the call number the span carries."""
    assert profiling._all_threads_config() is not None

    def on_pool():
        with timed_stage(None, "z_rans", 7):
            torch.ones(64).cumsum(0)
        return threading.get_native_id()

    with profiling.profile_trace(tmp_path):
        with ThreadPoolExecutor(1, thread_name_prefix="sic-z") as pool:
            pool_tid = pool.submit(on_pool).result()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e.get("name") == "z_rans"]
    assert len(spans) == 1 and spans[0]["tid"] == pool_tid != threading.get_native_id()
    assert spans[0]["args"]["Concrete Inputs"] == ["7"]


# -- the benchmark's readers ------------------------------------------------------

MAIN, OTHER = 11, 12
IMAGES = 4
# the window is [0, 1000] us on MAIN; the card runs [520, 600], [650, 700]
# and [880, 950]
RANGES = [("portbench.window", MAIN, 0, 1000),
          ("h_rans.code", MAIN, -50, 20), ("h_rans.code", MAIN, 100, 200),
          ("h_rans.code", MAIN, 300, 350), ("h_rans.fetch", MAIN, 200, 260),
          ("clip.embed", MAIN, 400, 500), ("maskgit.generate", MAIN, 500, 900),
          ("maskgit.step", MAIN, 510, 660), ("maskgit.uvit.skip", MAIN, 640, 650),
          ("h_rans.fetch", MAIN, 1100, 1200)]
OTHER_RANGES = [(name, OTHER, 0, 1000) for name in
                ("h_rans.code", "h_rans.fetch", "clip.embed", "maskgit.generate",
                 "maskgit.step", "maskgit.uvit.skip")]
KERNELS = [(520, 600), (650, 700), (880, 950)]
# by hand: host ms an image in the spans on MAIN clipped to the window, the
# card's idle time inside maskgit.generate ([500, 900] less 80 + 50 + 20),
# and the device time of the kernels launched (5 us before each starts)
# inside maskgit.step (the first two) and maskgit.uvit.skip (the second)
EXPECTED = {"h_code_ms_per_img": (20 + 100 + 50) * 1e-3 / IMAGES,
            "h_fetch_ms_per_img": 60 * 1e-3 / IMAGES,
            "clip_ms_per_img": 100 * 1e-3 / IMAGES,
            "sampler_idle_ms_per_img": (400 - 150) * 1e-3 / IMAGES,
            "gen_device_ms_per_img": (80 + 50) * 1e-3 / IMAGES,
            "uvit_skip_ms_per_img": 50 * 1e-3 / IMAGES}
SPAN = {"h_code_ms_per_img": "h_rans.code", "h_fetch_ms_per_img": "h_rans.fetch",
        "clip_ms_per_img": "clip.embed", "sampler_idle_ms_per_img": "maskgit.generate",
        "gen_device_ms_per_img": "maskgit.step",
        "uvit_skip_ms_per_img": "maskgit.uvit.skip"}


def _chrome(ranges):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": tid,
               "ts": a, "dur": b - a} for n, tid, a, b in ranges]
    for i, (a, b) in enumerate(KERNELS):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "pid": 1, "tid": MAIN, "ts": a - 5, "dur": 3,
                       "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{i}", "pid": 0, "tid": 7,
                       "ts": a, "dur": b - a, "args": {"correlation": i}})
    return {"traceEvents": events}


def _run(tmp_path, ranges):
    """A run as a reader sees it, its trace read from a Chrome trace file."""
    from portbench.harness.trace import Trace
    path = tmp_path / "hand.json"
    path.write_text(json.dumps(_chrome(ranges)))
    trace = Trace(json.loads(path.read_text())["traceEvents"])
    return types.SimpleNamespace(trace=trace, images=IMAGES)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_hand_computed_value(name, tmp_path):
    from portbench.harness.core import load_reader
    got = load_reader(name)(_run(tmp_path, RANGES))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_ignores_ranges_on_other_threads(name, tmp_path):
    from portbench.harness.core import load_reader
    got = load_reader(name)(_run(tmp_path, RANGES + OTHER_RANGES))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_its_span(name, tmp_path):
    """A trace without the span on the window's thread (the parent's
    program has none) gives no value; so does one with the span only on
    another thread."""
    from portbench.harness.core import load_reader
    read = load_reader(name)
    kept = [r for r in RANGES if r[0] != SPAN[name]]
    assert read(_run(tmp_path, kept)) is None
    assert read(_run(tmp_path, kept + OTHER_RANGES)) is None
    assert read(types.SimpleNamespace(trace=None, images=IMAGES)) is None
