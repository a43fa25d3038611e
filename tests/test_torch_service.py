"""The port's HTTP service over live HTTP on the CPU, case for case the JAX
package's ``tests/test_service.py`` (tiny spec, seeded codec and CLIP):
endpoints, ``X-SIC-*`` headers, NDJSON lines, ``/file`` gating, concurrent
micro-batching giving byte-identical answers, a corrupt stream failing
alone, ``/healthz``.  Besides: text search answers (the text tower is
ported), the JAX-encoded golden stream decodes within the golden bound
with the golden params named by ``CKPT_PATH``, and a ``BASE_CONFIG`` beside
an explicit spec is refused (both name the model)."""
import concurrent.futures
import io
import json
import threading
import urllib.error
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

GOLDEN = Path(__file__).resolve().parent / "fixtures" / "golden"


def _multipart(field, filename, payload):
    boundary = uuid.uuid4().hex
    body = io.BytesIO()
    body.write(f"--{boundary}\r\n".encode())
    body.write(f'Content-Disposition: form-data; name="{field}"; '
               f'filename="{filename}"\r\n'.encode())
    body.write(b"Content-Type: application/octet-stream\r\n\r\n")
    body.write(payload)
    body.write(f"\r\n--{boundary}--\r\n".encode())
    return body.getvalue(), f"multipart/form-data; boundary={boundary}"


def _serve(state):
    from sic_tpu_torch.service import make_server
    srv = make_server(state, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from sic_tpu_torch.service import ServiceState
    root = tmp_path_factory.mktemp("svc")
    state = ServiceState("tiny", index_dir=root / "faiss", media_root=root,
                         preview_cache=root / "previews", device="cpu")
    srv, base = _serve(state)
    yield base, state, root
    srv.shutdown()
    state.close()


def _post(url, data, content_type):
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": content_type})
    return urllib.request.urlopen(req, timeout=600)


def _png(shape, seed):
    arr = (np.random.default_rng(seed).uniform(size=(*shape, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _ndjson(resp):
    return [json.loads(l) for l in resp.read().decode().splitlines() if l.strip()]


def test_compress_decompress_endpoints(server):
    base, state, root = server
    body, ctype = _multipart("file", "t.png", _png((200, 260), 0))
    resp = _post(base + "/compress", body, ctype)
    assert resp.status == 200
    assert resp.headers["X-SIC-Stage"] == "compress"
    assert int(resp.headers["X-SIC-Elapsed-MS"]) > 0
    assert float(resp.headers["X-SIC-Elapsed-S"]) > 0
    assert resp.headers["X-SIC-Server-Clock"].endswith("Z")
    c2df = resp.read()
    assert c2df[:4] == b"C2DF"

    body, ctype = _multipart("file", "t.c2df", c2df)
    resp = _post(base + "/decompress", body, ctype)
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "image/png"
    assert resp.headers["X-SIC-Stage"] == "decompress"
    img = Image.open(io.BytesIO(resp.read()))
    assert img.size == (260, 200)  # padding cropped back

    # keep the bitstream for the search tests, and index it
    (root / "bits").mkdir(exist_ok=True)
    (root / "bits" / "t.c2df").write_bytes(c2df)
    from sic_tpu_torch.cli.build import build_index_from_c2df_dir
    build_index_from_c2df_dir(root / "bits", state.index_dir)


def test_search_stream_ndjson(server):
    base, state, root = server
    body, ctype = _multipart("file", "t.c2df", (root / "bits" / "t.c2df").read_bytes())
    resp = _post(base + "/search/stream/c2df?topk=3", body, ctype)
    assert resp.status == 200
    assert resp.headers["Content-Type"] == "application/x-ndjson"
    lines = _ndjson(resp)
    types = [l["type"] for l in lines]
    assert types[0] == "meta" and lines[0]["stage"] == "start"
    assert lines[0]["query_type"] == "c2df" and lines[0]["topk"] == 3
    assert "item" in types and types[-1] == "done"
    item = next(l for l in lines if l["type"] == "item")
    assert item["score"] == pytest.approx(1.0, abs=5e-3)  # bf16 scoring
    assert item["path"].endswith("t.c2df")
    assert item["preview_url"].startswith("/file?path=")

    # the preview URL serves the decoded PNG
    resp = urllib.request.urlopen(base + item["preview_url"], timeout=600)
    assert resp.read()[:8] == b"\x89PNG\r\n\x1a\n"


def test_search_stream_image(server):
    """An image query ranks the index's one stream (of the same image)
    first, with the CLIP vector the service's tower computes."""
    base, state, root = server
    body, ctype = _multipart("file", "t.png", _png((200, 260), 0))
    lines = _ndjson(_post(base + "/search/stream/image?topk=2", body, ctype))
    assert lines[0]["query_type"] == "image" and lines[-1]["type"] == "done"
    items = [l for l in lines if l["type"] == "item"]
    assert len(items) == 1 and items[0]["path"].endswith("t.c2df")
    assert np.isfinite(items[0]["score"])


def test_file_endpoint_gating(server):
    base, _, root = server
    secret = root / "secret.txt"
    secret.write_text("nope")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/file?path={secret}", timeout=30)
    assert e.value.code == 403


def test_file_endpoint_rejects_paths_outside_media_roots(server, tmp_path):
    base, _, _ = server
    outside = tmp_path / "outside.png"
    outside.write_bytes(b"\x89PNG\r\n\x1a\n" + b"0" * 16)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/file?path={outside}", timeout=30)
    assert e.value.code == 403


def test_search_text_endpoint(server):
    """Text search answers: the text tower and tokenizer are ported, so the
    stream ends in ``done`` with the index's one item."""
    base, _, _ = server
    body = json.dumps({"text": "an apple", "topk": 2}).encode()
    lines = _ndjson(_post(base + "/search/stream/text", body, "application/json"))
    assert lines[0]["query_type"] == "text" and lines[0]["query"] == "an apple"
    assert lines[-1]["type"] == "done"
    assert [l["type"] for l in lines].count("item") == 1
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/search/stream/text", b"{}", "application/json")
    assert e.value.code == 400


def test_decompress_microbatching_concurrent_identical_bytes(server):
    """Concurrent /decompress requests of one stream geometry share one
    batched decode, and each answer equals the sequential one byte for
    byte."""
    base, state, _root = server
    body, ctype = _multipart("file", "mb.png", _png((180, 220), 3))
    c2df = _post(base + "/compress", body, ctype).read()
    body, ctype = _multipart("file", "mb.c2df", c2df)
    seq_png = _post(base + "/decompress", body, ctype).read()
    assert seq_png[:8] == b"\x89PNG\r\n\x1a\n"

    # a wide window, so the grouping is deterministic under load
    from sic_tpu_torch.service.batcher import MicroBatcher
    state.batcher.close()
    state._batcher = MicroBatcher(state.runtime, window_ms=800)
    b0 = state._batcher.batches_dispatched
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        outs = list(pool.map(lambda _: _post(base + "/decompress", body,
                                             ctype).read(), range(4)))
    for png in outs:
        assert png == seq_png
    assert state._batcher.requests_served >= 4
    assert state._batcher.batches_dispatched - b0 <= 2  # grouped, not 4 singles


def test_compress_microbatching_concurrent_identical_bytes(server):
    """Concurrent /compress uploads of one padded shape share one batched
    encode; identical uploads give byte-identical .c2df answers."""
    base, state, _root = server
    body, ctype = _multipart("file", "cb.png", _png((150, 190), 11))
    solo = _post(base + "/compress", body, ctype).read()
    assert solo[:4] == b"C2DF"

    from sic_tpu_torch.service.batcher import EncodeBatcher
    state.enc_batcher.close()
    state._enc_batcher = EncodeBatcher(state.runtime, window_ms=800)
    b0 = state._enc_batcher.batches_dispatched
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        outs = list(pool.map(
            lambda _: _post(base + "/compress", body, ctype).read(), range(3)))
    for c in outs:
        assert c == solo  # grouping never changes bytes
    assert state._enc_batcher.requests_served >= 3
    assert state._enc_batcher.batches_dispatched - b0 <= 2

    # the grouped stream still decodes
    body, ctype = _multipart("file", "cb.c2df", outs[0])
    assert _post(base + "/decompress", body, ctype).read()[:8] == b"\x89PNG\r\n\x1a\n"


def test_corrupt_stream_in_a_group_fails_alone(server):
    """A corrupt upload whose header geometry matches the bucket gets its
    own 500; the good requests grouped with it are unharmed and
    byte-identical."""
    base, state, _root = server
    from sic_tpu_torch.container import pack_c2df, unpack_c2df
    body, ctype = _multipart("file", "iso.png", _png((160, 200), 17))
    good = _post(base + "/compress", body, ctype).read()
    good_body, good_ct = _multipart("file", "iso.c2df", good)
    seq_png = _post(base + "/decompress", good_body, good_ct).read()

    # the same geometry fields and a garbage h stream: same bucket, and
    # the decode raises
    enc, header = unpack_c2df(good)
    enc["h_bit_stream"] = b"\x00\x00\x00"
    bad_body, bad_ct = _multipart("file", "bad.c2df", pack_c2df(enc, header))

    from sic_tpu_torch.service.batcher import MicroBatcher
    state.batcher.close()
    state._batcher = MicroBatcher(state.runtime, window_ms=800)

    def post_bad():
        try:
            _post(base + "/decompress", bad_body, bad_ct)
        except urllib.error.HTTPError as e:
            return e.code
        return 200

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        goods = [pool.submit(lambda: _post(base + "/decompress", good_body,
                                           good_ct).read()) for _ in range(3)]
        bad_code = pool.submit(post_bad).result()
    assert bad_code == 500
    for f in goods:
        assert f.result() == seq_png


def test_healthz_and_page(server):
    base, _, _ = server
    resp = urllib.request.urlopen(f"{base}/healthz", timeout=30)
    assert resp.status == 200 and json.loads(resp.read()) == {"ok": True}
    resp = urllib.request.urlopen(f"{base}/", timeout=30)
    assert resp.headers["Content-Type"] == "text/html"
    assert b"PyTorch/CUDA" in resp.read()
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nothing", timeout=30)
    assert e.value.code == 404


def test_golden_stream_through_decompress(tmp_path, monkeypatch):
    """golden.c2df (encoded by the JAX package) posted to /decompress of a
    service whose CKPT_PATH names the golden params: the JAX package's
    golden bound against expected_u8.npz (max diff <= 1, < 1e-3 of pixels
    changed)."""
    from sic_tpu_torch.service import ServiceState
    monkeypatch.setenv("CKPT_PATH", str(GOLDEN / "params.npz"))
    state = ServiceState("tiny", index_dir=tmp_path / "faiss", media_root=tmp_path,
                         preview_cache=tmp_path / "previews", device="cpu")
    srv, base = _serve(state)
    try:
        body, ctype = _multipart("file", "golden.c2df",
                                 (GOLDEN / "golden.c2df").read_bytes())
        png = _post(base + "/decompress", body, ctype).read()
    finally:
        srv.shutdown()
        state.close()
    got = np.asarray(Image.open(io.BytesIO(png))).astype(np.int32)
    diff = np.abs(got - np.load(GOLDEN / "expected_u8.npz")["u8"].astype(np.int32))
    assert diff.max() <= 1, f"max pixel diff {diff.max()}"
    assert (diff != 0).mean() < 1e-3


def test_base_config_is_refused(monkeypatch, tmp_path):
    from sic_tpu_torch.service import ServiceState
    monkeypatch.setenv("BASE_CONFIG", "configs/any.yaml")
    with pytest.raises(ValueError, match="BASE_CONFIG"):
        ServiceState("tiny", preview_cache=tmp_path, device="cpu")
