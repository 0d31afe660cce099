"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` on first use, then loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
is rebuilt and never served stale. Every C entry returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

#: sm_90a (Hopper), IEEE division and no FMA contraction: the kernels must
#: round exactly as the reference's float32 arithmetic does. Never
#: --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signatures, by source: entry name → argument types. Every pointer and
#: the stream are ``c_void_p``; ints are ``c_int``, scalars ``c_float``.
SIGNATURES: dict[str, dict[str, list]] = {
    "nominate": {
        "koord_nominate": [_P] * 15 + [_I, _I, _I, _I, _F, _I, _P, _P, _P],
    },
    "commit": {
        "koord_commit": [_P] * 11 + [_F, _I, _I, _I, _P, _P],
        "koord_segment_sum": [_P, _P, _I, _I, _I, _P, _P],
    },
}

#: Kernel launches by wrapper name. Each wrapper adds one where it launches
#: its kernel and nowhere else, so a run can show which kernels it went
#: through.
launches: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def sources() -> list[Path]:
    """Every CUDA source the port builds."""
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build(names: "list[str] | None" = None) -> dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 for a library already on disk)."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    BUILD.mkdir(parents=True, exist_ok=True)
    seconds: dict[str, float] = {}
    procs = []
    t0 = time.perf_counter()
    for src in srcs:
        out = library_path(src)
        if out.exists():
            seconds[src.stem] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not library_path(src).exists():
        build([name])
    lib = ctypes.CDLL(str(library_path(src)))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.koord_error_string.argtypes = [ctypes.c_int]
    lib.koord_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.koord_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """A kernel launch takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: every tensor must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
