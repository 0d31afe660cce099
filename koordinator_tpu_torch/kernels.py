"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/lib<name>-<hash>.so`` on first use, then loaded with
``ctypes``. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and never
served stale. Every C entry returns
``cudaGetLastError()`` after its launch; :func:`check` raises on non-zero.
A kernel that cannot be built, loaded or launched raises
:class:`KernelError`.

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
#: --use_fast_math. ``-Xptxas -v`` writes each kernel's registers, shared
#: memory and spills into the build log (:func:`build_log`).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signatures, by source: entry name → argument types. Every pointer and
#: the stream are ``c_void_p`` (an int written back is ``POINTER(c_int)``);
#: ints are ``c_int``, scalars ``c_float``.
SIGNATURES: dict[str, dict[str, list]] = {
    "nominate": {
        "koord_nominate": [_P] * 15 + [_I] * 5 + [_F, _I, _I] + [_P] * 12 + [_I] * 3
        + [_P] * 9 + [_I, _I, _P],
        "koord_nominate_chunk": [_I] * 6 + [ctypes.POINTER(_I)],
    },
    "round": {
        "koord_round_tail": [_P] * 17 + [_F, _I, _I, _I, _I] + [_P] * 4 + [_I, _I]
        + [_P] * 8 + [_I, _P],
    },
    "round_zone": {
        "koord_round_tail_zone": [_P] * 17 + [_F, _I, _I, _I, _I] + [_P] * 4 + [_I, _I]
        + [_P] * 6 + [_I, _I] + [_P] * 8 + [_I, _P],
    },
    "round_big": {
        "koord_round_tail_big": [_P] * 17 + [_F, _I, _I, _I, _I] + [_P] * 4 + [_I, _I]
        + [_P] * 6 + [_I, _I] + [_P] * 8 + [_I, _P, _P],
        "koord_round_route": [_I] * 8 + [ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_longlong)],
    },
    "gangs": {
        "koord_enforce_gangs": [_P] * 11 + [_I, _I, _I] + [_P] * 2 + [_I, _I] + [_P] * 2
        + [_I, _I] + [_P] * 8 + [_I, _P, _P],
        "koord_gangs_scratch": [_I, _I, ctypes.POINTER(ctypes.c_longlong)],
    },
    "shortlist_build": {
        "koord_shortlist_build": [_P] * 14 + [_I] * 4 + [_F, _I] + [_P] * 8 + [_I] * 3
        + [_P] * 9 + [_I, _I, _P],
    },
    "shortlist_round": {
        "koord_shortlist_round": [_P] * 17 + [_I] * 5 + [_F, _I, _I] + [_P] * 11 + [_I] * 3
        + [_P] * 9 + [_I, _P],
    },
    "quota": {
        "koord_quota_gate": [_P] * 6 + [_I] * 4 + [_P],
    },
    "zone_prep": {
        "koord_zone_prep": [_P] * 5 + [_I] * 3 + [_P],
    },
    "device_prep": {
        "koord_device_prep": [_P] * 2 + [_I] * 2 + [_P],
    },
    "cost_full": {
        "koord_cost_full": [_P] * 15 + [_I] * 3 + [_P] * 9 + [_I] * 3 + [_P] * 9 + [_I, _P],
    },
    "nominate_cost": {
        "koord_nominate_cost": [_P] * 2 + [_I] * 3 + [_F, _I, _I] + [_P] * 4,
    },
}

#: Kernel launches by wrapper name, eager or replayed from a CUDA graph.
#: Each wrapper calls :func:`count` where it launches its kernel and nowhere
#: else, so a run can show which kernels it went through.
launches: collections.Counter = collections.Counter()
#: Wrapper launches recorded into a CUDA graph being captured: they run only
#: when the graph is replayed (:func:`replay`).
captured: collections.Counter = collections.Counter()
#: CUDA graph replays
replays: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand kernel could not be built or loaded, or the card refused or
    failed its launch. The scheduler's fallback ladder never absorbs it."""


class KernelArgumentError(KernelError, ValueError):
    """A launch refused before it reached the card: a tensor off the
    launch's CUDA device, of the wrong dtype or size, or not contiguous."""


def reset_launches() -> None:
    launches.clear()
    captured.clear()
    replays.clear()


def count(name: str) -> None:
    """One launch of wrapper ``name``'s kernel: counted in ``launches``,
    or in ``captured`` while the current stream is capturing a graph."""
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches[name] += 1


def replay(graph, name: str, nodes: collections.Counter, times: int) -> None:
    """Replay ``graph`` ``times`` times; it holds ``nodes`` wrapper
    launches by name, each of which runs once a replay."""
    for _ in range(times):
        graph.replay()
    replays[name] += times
    for kernel, n in nodes.items():
        launches[kernel] += n * times


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
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
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
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu`` ('' when the
    library was built before logs were kept)."""
    log = library_path(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not library_path(src).exists():
        build([name])
    try:
        lib = ctypes.CDLL(str(library_path(src)))
    except OSError as exc:
        raise KernelError(f"cannot load {library_path(src).name}: {exc}") from exc
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
        raise KernelError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def checked_ptrs(what: str, tensors, dtypes, sizes) -> list:
    """The data pointers of a launch's tensors (None stays None), after
    checking that each lies on the first tensor's CUDA device, has its
    dtype and number of elements and is contiguous; raises
    :class:`KernelArgumentError` (a ValueError) on any other tensor. The checks are cheap attribute reads: a launch's host
    time is most of a small kernel's time on the card."""
    index = tensors[0].get_device()
    ptrs = []
    for t, dtype, size in zip(tensors, dtypes, sizes):
        if t is None:
            ptrs.append(None)
            continue
        if index < 0 or t.get_device() != index:
            raise KernelArgumentError(f"{what}: every tensor must lie on one CUDA device")
        if t.dtype is not dtype or t.numel() != size:
            raise KernelArgumentError(
                f"{what}: expected {dtype} of {size} elements, got {t.dtype} {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise KernelArgumentError(f"{what}: tensors must be contiguous")
        ptrs.append(t.data_ptr())
    return ptrs
