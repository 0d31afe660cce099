"""Package rules of the PyTorch/CUDA port.

- it imports neither JAX nor any module of the JAX package (checked by
  running it with ``jax`` blocked, and by an AST scan);
- its constructors default to CUDA and raise without a card; its kernel
  wrappers launch or raise, never fall back;
- its build helper lists every CUDA source with its C entries, bound with
  as many arguments as each entry takes;
- ``chip_smoke.py`` keeps an exact copy of ``bench.build_fixture`` and
  fails, printing no result, where there is no card or no package.
"""

import ast
import ctypes
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import commit as tcommit
from koordinator_tpu_torch.ops import nominate as tnom
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "koordinator_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "koordinator_tpu", "bench", "bench_suite"}


def run_python(code, cwd=ROOT, args=()):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, *(["-c", code] if code else []), *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240,
    )


def test_runs_with_jax_blocked_and_loads_no_reference_module():
    """Every module of the port imports with ``jax`` blocked; the solver
    and a scheduling cycle of the seam's recipe run on the CPU."""
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None  # any import of it raises ImportError
import numpy as np
import chip_smoke
import koordinator_tpu_torch
modules = [m.name for m in pkgutil.walk_packages(koordinator_tpu_torch.__path__,
                                                 "koordinator_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
from koordinator_tpu_torch.ops import convert, solver
nodes, pods, params = chip_smoke.headline_inputs(chip_smoke.build_fixture(0, 64, 128))
res = solver.assign(
    convert.from_numpy(solver.PodBatch, device="cpu", **pods),
    convert.from_numpy(solver.NodeState, device="cpu", **nodes),
    convert.from_numpy(solver.SolverParams, device="cpu", **params),
    max_rounds=12, approx_topk=True,
)
_, (cycle,) = chip_smoke.seam_cycles(chip_smoke.port_modules(), 16, 40, waves=0, device="cpu")
loaded = [m for m in sys.modules if m.split(".")[0] in ("koordinator_tpu", "bench")]
assert not loaded, loaded
assert len(modules) > 50 and len(cycle["bound"]) == 40, (len(modules), cycle)
print("placed", int((res.assignment >= 0).sum()))
"""
    out = run_python(code)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 100


def port_sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: import {name}"
    # no import the scan cannot see: a module named at run time
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            assert node.id not in ("importlib", "__import__"), f"{path}: {node.id}"
        elif isinstance(node, ast.alias):
            assert node.name.split(".")[0] != "importlib", f"{path}: import {node.name}"


def test_constructors_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    alloc = np.ones((3, 2), np.float32)
    calls = [
        lambda: T.NodeState.create(alloc),
        lambda: T.PodBatch.create(alloc, np.zeros(3, np.int32)),
        lambda: T.SolverParams.create(np.ones(2), np.ones(2), np.ones(2)),
        lambda: T.QuotaState.disabled(2),
        lambda: from_numpy(T.NodeState, allocatable=alloc),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert T.NodeState.create(alloc, device="cpu").allocatable.device.type == "cpu"


def test_wrappers_launch_or_raise_never_fall_back():
    """A tensor that is neither on the CPU nor on CUDA is refused, not
    handed to the plain version."""
    meta = torch.empty((4, 2), device="meta")
    flags = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tnom.nominate(meta, meta, flags, flags, flags, meta, meta, meta, meta,
                      flags, flags, meta[:, 0], meta, meta, meta[0], 1, 4.0, False)
    ints = flags.int()
    with pytest.raises(ValueError, match="CUDA"):
        tcommit.round_tail(meta, ints[:, None], meta, meta, flags, flags, meta[:, 0],
                           meta, flags, meta, meta, meta, meta, meta, ints, flags,
                           ints[:2], 0.35)
    result = T.SolveResult(
        assignment=ints, node_requested=meta, node_estimated_used=meta,
        node_prod_used=meta, quota_used=meta[:1], rounds_used=ints[0],
    )
    pods = T.PodBatch(
        requests=meta, estimate=meta, priority=ints, is_prod=flags, valid=flags,
        gang_id=ints, gang_min=ints, quota_chain=ints[:, None], qos=ints,
        gpu_whole=ints, gpu_share=meta[:, 0], gang_nonstrict=flags,
    )
    with pytest.raises(ValueError, match="CUDA"):
        T.enforce_gangs(result, pods)


def test_build_helper_lists_every_source_and_entry():
    cu = sorted((PACKAGE / "csrc").glob("*.cu"))
    assert kernels.sources() == cu and [p.stem for p in cu] == sorted(kernels.SIGNATURES)
    for src in cu:
        text = src.read_text()
        for entry in kernels.SIGNATURES[src.stem]:
            assert f" {entry}(" in text and 'extern "C"' in text, entry
        assert "koord_error_string" in text
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert kernels.BUILD == PACKAGE / "build"
    assert "koordinator_tpu_torch/build/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize(
    "src, entry",
    [(src, entry) for src, entries in kernels.SIGNATURES.items() for entry in entries],
)
def test_c_entry_takes_the_bound_arguments(src, entry):
    """ctypes passes exactly what ``SIGNATURES`` binds: the C entry must
    take as many arguments, pointers where pointers are bound."""
    text = (PACKAGE / "csrc" / f"{src}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    params = [p.strip() for p in m.group(1).split(",")]
    bound = kernels.SIGNATURES[src][entry]
    assert len(params) == len(bound)
    for param, argtype in zip(params, bound):
        assert ("*" in param) == (argtype is not ctypes.c_int and argtype is not ctypes.c_float), param


def test_chip_smoke_fixture_is_bench_fixture():
    want, got = bench.build_fixture(0), chip_smoke.build_fixture(0)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
        assert want[k].dtype == got[k].dtype
    assert (chip_smoke.N_NODES, chip_smoke.N_PODS, chip_smoke.BATCH) == (
        bench.N_NODES, bench.N_PODS, bench.BATCH,
    )
    assert chip_smoke.SOLVE == dict(max_rounds=bench.MAX_ROUNDS, approx_topk=True)
    assert chip_smoke.THRESHOLDS == bench.THRESHOLDS


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_python(None, args=[str(ROOT / "chip_smoke.py")])
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_python(None, cwd=tmp_path, args=["chip_smoke.py"])
    assert out.returncode != 0 and '"ok"' not in out.stdout
