"""A run with the timed path broken underneath comes out not correct:
each fault the cells can have, planted in the program on the CPU at the
tiny presets (the run past its look for a card), judged by the cells'
own limits."""
import pytest
import torch

from ._util import run_cell


@pytest.fixture
def runtime_cls():
    from sic_tpu_torch.models import CodecRuntime
    return CodecRuntime


def _half_batch(out):
    """Half of the batch left out: its first half stands in for the rest."""
    h = max(1, out.shape[0] // 2)
    return torch.cat([out[:h]] * (out.shape[0] // h + 1))[:out.shape[0]]


# -- decompress --------------------------------------------------------------

def test_decompress_altered_token(monkeypatch, runtime_cls):
    orig = runtime_cls._decode_z

    def bad(self, stream, n, coder):
        ids = orig(self, stream, n, coder).copy()
        ids[::3] = (ids[::3] + 1) % self.spec.titok.codebook_size
        return ids
    monkeypatch.setattr(runtime_cls, "_decode_z", bad)
    assert run_cell("flagship.decompress")["correct"] is False


def test_decompress_half_batch(monkeypatch, runtime_cls):
    orig = runtime_cls.decode_only_batched
    monkeypatch.setattr(runtime_cls, "decode_only_batched",
                        lambda self, *a, **k: _half_batch(orig(self, *a, **k)))
    assert run_cell("flagship.decompress")["correct"] is False


def test_decompress_stale_state(monkeypatch, runtime_cls):
    """A step that hands back the previous batch's answer."""
    orig = runtime_cls.decode_only_batched
    last = {}

    def stale(self, *a, **k):
        out = orig(self, *a, **k)
        prev = last.get("x")
        last["x"] = out
        return out if prev is None else prev
    monkeypatch.setattr(runtime_cls, "decode_only_batched", stale)
    assert run_cell("flagship.decompress")["correct"] is False


# -- generate ----------------------------------------------------------------

@pytest.fixture
def maskgit():
    from sic_tpu_torch.models import maskgit
    return maskgit


def test_generate_altered_token(monkeypatch, maskgit):
    orig = maskgit.generate

    def bad(*a, **k):
        ids = orig(*a, **k).clone()
        ids[:, 0] = (ids[:, 0] + 1) % a[0].spec.codebook_size
        return ids
    monkeypatch.setattr(maskgit, "generate", bad)
    assert run_cell("titok.generate")["correct"] is False


def test_generate_half_batch(monkeypatch, maskgit):
    orig = maskgit.generate

    def half(model, g, cond, **k):
        h = max(1, cond.shape[0] // 2)
        return _half_batch(orig(model, g, torch.cat([cond[:h]] * 2)[:cond.shape[0]], **k))
    monkeypatch.setattr(maskgit, "generate", half)
    assert run_cell("titok.generate")["correct"] is False


def test_generate_stale_state(monkeypatch, maskgit):
    """A sampler step that returns its state unchanged: the generator's
    logits ignore the tokens it is given."""
    orig = maskgit.MaskGITGenerator.forward

    def blind(self, ids, cond, drop):
        return orig(self, torch.full_like(ids, self.spec.mask_token_id), cond, drop)
    monkeypatch.setattr(maskgit.MaskGITGenerator, "forward", blind)
    assert run_cell("titok.generate")["correct"] is False


# -- compress ----------------------------------------------------------------

def test_compress_altered_stream(monkeypatch, runtime_cls):
    orig = runtime_cls.encode_only_batched

    def bad(self, *a, **k):
        encs = orig(self, *a, **k)
        for e in encs:
            b = bytearray(e["h_bit_stream"])
            b[-1] ^= 0x5A
            e["h_bit_stream"] = bytes(b)
        return encs
    monkeypatch.setattr(runtime_cls, "encode_only_batched", bad)
    assert run_cell("flagship.compress")["correct"] is False


def test_compress_half_batch(monkeypatch, runtime_cls):
    orig = runtime_cls.encode_only_batched

    def half(self, x, *a, **k):
        h = max(1, x.shape[0] // 2)
        encs = orig(self, x[:h], *a, **k) if h > 1 else orig(self, x, *a, **k)[:1]
        return (encs * (x.shape[0] // h + 1))[:x.shape[0]]
    monkeypatch.setattr(runtime_cls, "encode_only_batched", half)
    assert run_cell("flagship.compress")["correct"] is False
