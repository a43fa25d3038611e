"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``sic_tpu_torch/_build/``, git-ignored), loaded
through ctypes.  The build runs at first use and is keyed by a hash of the
sources and flags; :func:`build` starts one ``nvcc`` per missing library,
all at once.  Nothing here runs at import time: machines without ``nvcc``
(CPU-only test runs) import the package and use the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("seq_attention", "window_attention", "window_attention_bwd",
           "rans_decode", "rans_encode", "window_attention_gsd", "group_norm")
_HEADERS = ("attention_tc.cuh", "mbarrier.cuh", "rans_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *(CSRC / n for n in _HEADERS)):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing kernel library, one ``nvcc`` process per
    source, all started together.  Returns ``{name: ptxas report}`` for
    the libraries built by this call (registers, shared memory, spills)."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True),
                    tmp, out)
    reports, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"[{n}] nvcc exit {proc.returncode}\n{stdout}{stderr}")
            continue
        tmp.replace(out)
        reports[n] = stderr
        out.with_suffix(".ptxas.txt").write_text(stderr)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


_count_lock = threading.Lock()


def count_launch(wrapper, dtype: torch.dtype = torch.float32,
                 head_dim: Optional[int] = None, heads: Optional[int] = None) -> None:
    """Add one to ``wrapper.launches``, to ``wrapper.launches_bf16`` for a
    launch of its bf16 entry, with ``head_dim`` to that head dim's entry of
    ``wrapper.launches_by_head_dim`` and with ``heads`` to that head
    count's entry of ``wrapper.launches_by_heads``.  Wrappers launch from
    several threads at once (``CodecRuntime.decode_only_many``), and ``+=``
    on an attribute is not atomic, so the add holds a lock."""
    with _count_lock:
        wrapper.launches += 1
        if dtype == torch.bfloat16:
            wrapper.launches_bf16 += 1
        if head_dim is not None:
            by = wrapper.launches_by_head_dim
            by[head_dim] = by.get(head_dim, 0) + 1
        if heads is not None:
            by = wrapper.launches_by_heads
            by[heads] = by.get(heads, 0) + 1


def check_launch(rc: int, name: str) -> None:
    """Raise if the C launcher reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def require_cuda(t: torch.Tensor, name: str, dtypes) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    (a dtype, or a tuple of those a kernel has an entry for)."""
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        want = " or ".join(str(d) for d in dtypes)
        raise ValueError(f"{name} must be {want}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def entry_symbol(base: str, dtype: torch.dtype) -> str:
    """The C symbol of a kernel's entry for ``dtype``: ``base`` for f32,
    ``base + "_bf16"`` for bf16 (one library holds both)."""
    return base if dtype == torch.float32 else f"{base}_bf16"


def _kernel_name(demangled: str) -> str:
    """"void <unnamed>::k<float, (int)2>(CUtensorMap_st, float *)" ->
    "k<float, 2>": the parameter list (from the parenthesis that closes
    the name) and the scope and casts dropped."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0 and demangled[i] == "(":
            demangled = demangled[:i]
            break
    name = demangled.removeprefix("void ").split("::")[-1]
    return name.replace("(int)", "")


def sass_hgmma(name: str) -> dict:
    """HGMMA (wgmma) instructions in each kernel function of library
    ``name``'s SASS (``cuobjdump -sass``), by demangled function name:
    ``{"hgmma": n, "bf16": m}``, m of them with bf16 operands.  A bf16
    entry whose kernel compiled to no bf16 tensor-core instruction shows
    as ``bf16: 0``."""
    bin_dir = Path(nvcc_path()).parent
    out = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump -sass {name}: {out.stderr.strip()}")
    counts: dict = {}
    fn = None
    for ln in out.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            counts[fn] = {"hgmma": 0, "bf16": 0}
        elif fn is not None and "HGMMA" in ln:
            counts[fn]["hgmma"] += 1
            counts[fn]["bf16"] += "BF16" in ln
    filt = bin_dir / "cu++filt"
    if counts and filt.exists():
        res = subprocess.run([str(filt)], input="\n".join(counts), capture_output=True,
                             text=True, timeout=60)
        names = res.stdout.splitlines()
        if res.returncode == 0 and len(names) == len(counts):
            counts = {_kernel_name(n): c for n, c in zip(names, counts.values())}
    return counts
