"""HTTP service: the JAX package's endpoint protocol on the port's runtime.

    python -m sic_tpu_torch.service.app [--host 0.0.0.0] [--port 8000]
        [--base_config CONFIG.yaml | --spec flagship|small|tiny]
        [--device cuda] [--dtype auto|float32|bfloat16]

Endpoints (reference: webapp.py:63-325):

- ``GET  /``                      -> static/index.html
- ``GET  /static/<f>``            -> static assets
- ``GET  /file?path=...``         -> media files under the media roots only
- ``GET  /healthz``               -> ``{"ok": true}``
- ``POST /compress``              -> multipart image -> .c2df
- ``POST /decompress``            -> multipart .c2df -> PNG
- ``POST /search/stream/text``    -> JSON body -> NDJSON stream
- ``POST /search/stream/image``   -> multipart -> NDJSON stream
- ``POST /search/stream/c2df``    -> multipart -> NDJSON stream

Codec responses carry the ``X-SIC-Stage`` / ``X-SIC-Elapsed-MS`` /
``X-SIC-Elapsed-S`` timing headers (webapp.py:41-48).  The models load once,
in process, at first use, and run the port's runtime on ``device`` (CUDA
unless named) in the compute dtype of ``--dtype`` or ``SIC_DTYPE`` (auto:
bf16 on CUDA, fp32 on the CPU, as the JAX service runs bf16 on an
accelerator; CLIP stays fp32), W8A8 int8 with ``SIC_QUANT=int8`` (read by
``load_runtime``, as the JAX service reads it); concurrent requests share batched device
work through ``service/batcher.py``.  The environment is read as the JAX
service reads it: ``BASE_CONFIG`` (a reference-layout YAML, which gives the
model in place of ``--spec``), ``CKPT_PATH``, ``CLIP_CKPT``, ``INDEX_DIR``,
``MEDIA_ROOT`` and ``PREVIEW_CACHE``.  Built on the stdlib ``http.server``
(threaded).
"""
from __future__ import annotations

import datetime
import email
import email.policy
import hashlib
import io
import json
import os
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, quote, urlparse

import numpy as np

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".webp", ".bmp"}
_MIME = {".png": "image/png", ".jpg": "image/jpeg", ".jpeg": "image/jpeg",
         ".webp": "image/webp", ".bmp": "image/bmp",
         ".c2df": "application/octet-stream", ".html": "text/html",
         ".js": "text/javascript", ".css": "text/css"}


def _timing_headers(elapsed_ms: int, stage: str) -> Dict[str, str]:
    return {
        "X-SIC-Stage": stage,
        "X-SIC-Elapsed-MS": str(int(elapsed_ms)),
        "X-SIC-Elapsed-S": f"{elapsed_ms / 1000:.3f}",
        "X-SIC-Server-Clock":
            datetime.datetime.now(datetime.timezone.utc)
            .isoformat().replace("+00:00", "Z"),
        "Access-Control-Expose-Headers":
            "X-SIC-Stage, X-SIC-Elapsed-MS, X-SIC-Elapsed-S, "
            "X-SIC-Server-Clock, Content-Disposition, Content-Type",
    }


def parse_multipart(body: bytes, content_type: str) -> Dict[str, Tuple[Optional[str], bytes]]:
    """Minimal multipart/form-data parser -> {field: (filename, payload)}."""
    msg = email.message_from_bytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body,
        policy=email.policy.HTTP)
    out = {}
    if not msg.is_multipart():
        return out
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        filename = part.get_param("filename", header="content-disposition")
        payload = part.get_payload(decode=True)
        if name is not None:
            out[name] = (filename, payload or b"")
    return out


class ServiceState:
    """Models, batchers and indexes of one service, loaded at first use.

    ``spec``: a ``CodecSpec`` or the name of a preset (``flagship``,
    ``small``, ``tiny``); ``base_config`` (or ``BASE_CONFIG``): a
    reference-layout YAML whose spec the service runs instead; naming both
    is an error, and with neither the spec is the flagship.  ``device``:
    where the models and the index searches run (CUDA unless named).
    ``dtype`` (or ``SIC_DTYPE``): the codec's compute dtype, ``auto``
    (bf16 on CUDA, fp32 on the CPU), ``float32`` or ``bfloat16``.
    Paths left as None come from the environment, as in the JAX service."""

    def __init__(self, spec=None, ckpt_path=None, index_dir=None,
                 media_root=None, preview_cache=None, clip_ckpt=None,
                 static_dir=None, device=None, base_config=None, dtype=None):
        self.base_config = base_config or os.getenv("BASE_CONFIG") or None
        if self.base_config:
            if spec is not None:
                raise ValueError(f"BASE_CONFIG ({self.base_config}) and the "
                                 f"spec {spec!r} both name the model: give one")
            from ..config import load_config
            spec = load_config(self.base_config).spec
        if isinstance(spec, str) or spec is None:
            from .. import config
            spec = getattr(config, f"{spec or 'flagship'}_spec")()
        self.spec = spec
        self.device = device
        self.dtype = dtype or os.getenv("SIC_DTYPE") or "auto"
        self.ckpt_path = ckpt_path or os.getenv("CKPT_PATH") or None
        self.clip_ckpt = clip_ckpt or os.getenv("CLIP_CKPT") or None
        self.index_dir = Path(index_dir or os.getenv("INDEX_DIR", "./IO/faiss")).resolve()
        self.media_root = Path(media_root or os.getenv("MEDIA_ROOT", "./")).resolve()
        self.preview_cache = Path(preview_cache
                                  or os.getenv("PREVIEW_CACHE", "./cache/previews")).resolve()
        self.preview_cache.mkdir(parents=True, exist_ok=True)
        self.static_dir = Path(static_dir or Path(__file__).parent / "static")
        self._lock = threading.Lock()
        self._rt = None
        self._clip = None
        self._batcher = None
        self._enc_batcher = None
        self._search_batcher = None
        self._index_cache: Dict[str, tuple] = {}

    @property
    def runtime(self):
        with self._lock:
            if self._rt is None:
                from ..cli._common import load_runtime
                self._rt = load_runtime(self.ckpt_path, self.spec,
                                        device=self.device, dtype=self.dtype)
            return self._rt

    @property
    def batcher(self):
        rt = self.runtime          # resolved outside the lock (it locks too)
        with self._lock:
            if self._batcher is None:
                from .batcher import MicroBatcher
                self._batcher = MicroBatcher(rt)
            return self._batcher

    @property
    def enc_batcher(self):
        rt = self.runtime
        with self._lock:
            if self._enc_batcher is None:
                from .batcher import EncodeBatcher
                self._enc_batcher = EncodeBatcher(rt)
            return self._enc_batcher

    @property
    def clip(self):
        with self._lock:
            if self._clip is None:
                from ..cli._common import load_clip_codec
                self._clip = load_clip_codec(self.clip_ckpt, device=self.device)
            return self._clip

    def index(self, index_dir=None):
        """The index of ``index_dir`` (default: the service's), loaded again
        when its files change."""
        from ..retrieval import VectorIndex
        key = str(Path(index_dir or self.index_dir).resolve())
        mtime = 0.0
        for f in ("faiss.index", "index.faiss"):
            p = Path(key) / f
            if p.exists():
                mtime = max(mtime, p.stat().st_mtime)
        with self._lock:
            cached = self._index_cache.get(key)
            if cached and cached[0] == mtime:
                return cached[1]
            idx, _meta = VectorIndex.load(key, device=self.device)
            self._index_cache[key] = (mtime, idx)
            return idx

    def close(self) -> None:
        """Stop the batchers' workers and the runtime's host threads."""
        for b in (self._batcher, self._enc_batcher, self._search_batcher):
            if b is not None:
                b.close()
        if self._rt is not None:
            self._rt.close()

    # -- operations -----------------------------------------------------------
    def compress_bytes(self, filename: str, data: bytes) -> List[Tuple[str, bytes]]:
        """Image bytes -> [(out name, c2df bytes)], through the encode
        batcher: concurrent uploads of one padded shape share one batched
        encode.  The container the compress CLI writes, field for field,
        without its clip_vecs and index side outputs."""
        import torch

        from ..cli.compress import c2df_header
        from ..container import pack_c2df
        from ..data import load_image
        from ..models import get_padding_size, pad_replicate

        rt, clip_codec = self.runtime, self.clip
        img = load_image(io.BytesIO(data))            # (H, W, 3) in [-1, 1]
        H, W = img.shape[:2]
        pads = get_padding_size(H, W, self.spec.tile_px)
        x = pad_replicate(torch.from_numpy(img)[None], pads)
        enc_result = self.enc_batcher.encode(x)
        clip_vec = clip_codec.image_to_unit_vec(img)
        clip_stream, clip_meta = clip_codec.quantize_u8_and_compress(clip_vec)
        enc_result["clip_stream"] = clip_stream
        enc_result["clip_meta"] = clip_meta
        header = c2df_header(rt, clip_meta, (H, W), pads)
        return [(f"{Path(filename).stem}.c2df",
                 pack_c2df(enc_result, header))]

    def decompress_bytes(self, filename: str, data: bytes) -> List[Tuple[str, bytes]]:
        """c2df bytes -> [(png name, png bytes)], through the decode
        batcher: concurrent streams of one geometry share one batched
        decode.  Header handling is the decompress CLI's, files without a
        coding_batch marker included."""
        from PIL import Image

        from ..container import sanitize_enc_result_types, unpack_c2df
        enc, header = unpack_c2df(data)
        enc = sanitize_enc_result_types(enc)
        enc["z_coder"] = header.get("z_coder", "torchac")
        enc["coding_batch"] = int(header.get("coding_batch", 1))
        img = self.batcher.decode(enc, output="u8")
        left, right, top, bot = header.get("padding", [0, 0, 0, 0])
        H, W = img.shape[:2]
        img = img[top:H - bot if bot else H, left:W - right if right else W]
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return [(f"{Path(filename).stem}.png", buf.getvalue())]

    def search(self, q: np.ndarray, topk: int, index_dir=None):
        """One query -> [(doc id, score), ...] through the search batcher
        (concurrent queries against one index share one scoring wave);
        row for row the search CLI's ``do_search``."""
        with self._lock:
            if self._search_batcher is None:
                from .batcher import SearchBatcher
                self._search_batcher = SearchBatcher()
        index = self.index(index_dir)
        scores, ids = self._search_batcher.search(index, q, topk)
        return [(index.ids[int(i)], float(s)) for s, i in zip(scores, ids)
                if i >= 0]

    def media_roots(self) -> Tuple[Path, ...]:
        """Directories ``GET /file`` may serve from."""
        return (self.media_root, self.index_dir, self.index_dir.parent,
                self.preview_cache)

    def path_in_roots(self, p: Path) -> bool:
        """True iff the resolved path lies under one of the media roots
        (the reference serves any image path it is given,
        webapp.py:67-74)."""
        try:
            rp = p.resolve()
        except Exception:
            return False
        for root in self.media_roots():
            try:
                rr = root.resolve()
            except Exception:
                continue
            if rp == rr or rr in rp.parents:
                return True
        return False

    # -- previews (reference: webapp.py:76-112) ---------------------------------
    def resolve_media_path(self, raw: str) -> Optional[Path]:
        try:
            p = Path(raw).expanduser()
        except Exception:
            return None
        if p.exists() and p.is_file():
            return p.resolve()
        name = Path(raw).name
        for root in (self.media_root, self.index_dir, self.index_dir.parent):
            try:
                for cand in root.rglob(name):
                    if cand.is_file() and (cand.suffix.lower() in IMAGE_EXTS
                                           or cand.suffix.lower() == ".c2df"):
                        return cand.resolve()
            except Exception:
                continue
        return None

    def preview_url(self, path: str) -> str:
        p = self.resolve_media_path(path)
        if not p:
            return ""
        if p.suffix.lower() in IMAGE_EXTS:
            return f"/file?path={quote(str(p))}"
        if p.suffix.lower() == ".c2df":
            st = p.stat()
            key = hashlib.sha1(
                (str(p) + f"|{int(st.st_mtime)}|{st.st_size}").encode()).hexdigest()
            out_png = self.preview_cache / f"{key}.png"
            if not out_png.exists():
                try:
                    outs = self.decompress_bytes(p.name, p.read_bytes())
                    if outs:
                        out_png.write_bytes(outs[0][1])
                except Exception:
                    return f"/file?path={quote(str(p))}"
            if out_png.exists():
                return f"/file?path={quote(str(out_png))}"
        return ""


def make_handler(state: ServiceState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- plumbing ---------------------------------------------------------
        def _send(self, code: int, body: bytes, content_type: str,
                  headers: Optional[Dict[str, str]] = None,
                  filename: Optional[str] = None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if filename:
                self.send_header("Content-Disposition",
                                 f'attachment; filename="{filename}"')
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, detail: str):
            self._send(code, json.dumps({"detail": detail}).encode(),
                       "application/json")

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n) if n else b""

        def _stream_ndjson(self, gen):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for obj in gen:
                data = (json.dumps(obj, ensure_ascii=False) + "\n").encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        # -- GET ----------------------------------------------------------------
        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send(200, b'{"ok": true}', "application/json")
                return
            if url.path == "/":
                page = state.static_dir / "index.html"
                if page.exists():
                    self._send(200, page.read_bytes(), "text/html")
                else:
                    self._error(404, "no UI installed")
                return
            if url.path.startswith("/static/"):
                f = (state.static_dir / url.path[len("/static/"):]).resolve()
                if state.static_dir.resolve() in f.parents and f.is_file():
                    self._send(200, f.read_bytes(),
                               _MIME.get(f.suffix.lower(),
                                         "application/octet-stream"))
                else:
                    self._error(404, "File not found")
                return
            if url.path == "/file":
                raw = parse_qs(url.query).get("path", [""])[0]
                p = Path(raw).resolve()
                if not p.exists() or not p.is_file():
                    self._error(404, "File not found")
                    return
                if p.suffix.lower() not in IMAGE_EXTS and p.suffix.lower() != ".c2df":
                    self._error(403, "Forbidden file type")
                    return
                if not state.path_in_roots(p):
                    self._error(403, "Path outside media roots")
                    return
                self._send(200, p.read_bytes(),
                           _MIME.get(p.suffix.lower(), "application/octet-stream"),
                           filename=p.name)
                return
            self._error(404, "Not found")

        # -- POST ----------------------------------------------------------------
        def do_POST(self):
            url = urlparse(self.path)
            try:
                if url.path == "/compress":
                    return self._codec_endpoint("compress")
                if url.path == "/decompress":
                    return self._codec_endpoint("decompress")
                if url.path == "/search/stream/text":
                    return self._search_text()
                if url.path in ("/search/stream/image", "/search/stream/c2df"):
                    return self._search_file(url)
                self._error(404, "Not found")
            except BrokenPipeError:
                pass
            except Exception as e:  # -> HTTP 500 (reference: webapp.py:140-141)
                self._error(500, f"Inference failed: {e}")

        def _get_upload(self):
            parts = parse_multipart(self._read_body(),
                                    self.headers.get("Content-Type", ""))
            if "file" not in parts or parts["file"][0] is None:
                return None, None
            return parts["file"][0], parts["file"][1]

        def _codec_endpoint(self, stage: str):
            filename, data = self._get_upload()
            if filename is None:
                return self._error(400, "file is required")
            t0 = time.perf_counter()
            op = (state.compress_bytes if stage == "compress"
                  else state.decompress_bytes)
            outs = op(filename, data)
            elapsed_ms = int((time.perf_counter() - t0) * 1000)
            if not outs:
                return self._error(404, "No outputs found")
            if len(outs) == 1:
                name, payload = outs[0]
                mime = _MIME.get(Path(name).suffix.lower(),
                                 "application/octet-stream")
                return self._send(200, payload, mime,
                                  _timing_headers(elapsed_ms, stage), name)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, payload in outs:
                    zf.writestr(name, payload)
            return self._send(200, buf.getvalue(), "application/zip",
                              _timing_headers(elapsed_ms, stage),
                              f"{stage}_outputs.zip")

        def _search_common(self, gen_query, meta: Dict, topk: int, index_dir):
            def gen():
                t0 = time.perf_counter()
                yield {"type": "meta", "stage": "start", **meta}
                try:
                    q = gen_query()
                    results = state.search(q, topk, index_dir)
                    yield {"type": "meta", "stage": "searched",
                           "count": len(results),
                           "elapsed_ms": int((time.perf_counter() - t0) * 1000)}
                    for p, s in results:
                        yield {"type": "item", "path": p, "score": s,
                               "preview_url": state.preview_url(p)}
                    yield {"type": "done",
                           "elapsed_ms": int((time.perf_counter() - t0) * 1000)}
                except Exception as e:
                    yield {"type": "error", "detail": str(e)}
            self._stream_ndjson(gen())

        def _search_text(self):
            body = json.loads(self._read_body() or b"{}")
            text = (body.get("text") or "").strip()
            topk = int(body.get("topk") or 10)
            index_dir = body.get("index_dir")
            if not text:
                return self._error(400, "text is required")
            self._search_common(
                lambda: state.clip.text_to_unit_vec(text)[0],
                {"query_type": "text", "query": text, "topk": topk},
                topk, index_dir)

        def _search_file(self, url):
            qs = parse_qs(url.query)
            topk = int(qs.get("topk", ["10"])[0])
            index_dir = qs.get("index_dir", [None])[0]
            filename, data = self._get_upload()
            if filename is None:
                return self._error(400, "file is required")
            kind = "c2df" if url.path.endswith("c2df") else "image"

            def q_fn():
                if kind == "c2df":
                    from ..container import unpack_c2df
                    from ..retrieval import decode_clip_stream
                    enc, _ = unpack_c2df(data)
                    return decode_clip_stream(enc["clip_stream"],
                                              enc["clip_meta"])
                from PIL import Image
                return state.clip.image_to_unit_vec(Image.open(io.BytesIO(data)))

            self._search_common(
                q_fn, {"query_type": kind, "filename": filename, "topk": topk},
                topk, index_dir)

    return Handler


def make_server(state: Optional[ServiceState] = None, host: str = "0.0.0.0",
                port: int = 8000) -> ThreadingHTTPServer:
    state = state or ServiceState()
    return ThreadingHTTPServer((host, port), make_handler(state))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="sic_tpu_torch service")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--base_config", default=None,
                    help="reference-layout YAML config (or BASE_CONFIG); "
                         "excludes --spec")
    ap.add_argument("--spec", choices=["flagship", "small", "tiny"],
                    default=None, help="model preset (default flagship)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--dtype", choices=["auto", "float32", "bfloat16"],
                    default=None, help="codec compute dtype (or SIC_DTYPE; "
                    "default auto: bfloat16 on CUDA, float32 on the CPU)")
    args = ap.parse_args(argv)
    srv = make_server(ServiceState(args.spec, device=args.device,
                                   base_config=args.base_config,
                                   dtype=args.dtype),
                      port=args.port, host=args.host)
    print(f"[sic_tpu_torch] serving on http://{args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
