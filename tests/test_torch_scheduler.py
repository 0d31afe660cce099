"""The scheduler seam: the port's ``BatchScheduler.schedule`` against the
JAX package's on the CPU.

One recipe builds both sides: ``chip_smoke.production_scheduler`` and
``chip_smoke.production_pods`` take one package's modules
(``chip_smoke.SeamModules``: the port's from ``chip_smoke.port_modules``,
the reference's from ``tools/make_torch_golden.reference_modules``), so
the snapshot, the NUMA, device, quota and reservation managers and the
pods are the same objects of each package (the
``__graft_entry__._dryrun_production_scheduler`` cluster: 2-socket
SingleNUMANode nodes with 4 GPUs, the ``dry-team`` quota, the
``dry-resv`` reservation and its owner, LSR cpuset pods and GPU pods),
here at 64 nodes and 200 pods in buckets of 64 (several chunks). Each case
requires the same bound pods, nodes, ``ANNOTATION_RESOURCE_STATUS``,
``ANNOTATION_DEVICE_ALLOCATED`` and ``ANNOTATION_RESERVATION_ALLOCATED``
and the same unschedulable pods. One run of each package covers the
scanned path (``solve_stream_full``) with node selectors (the stacked
mask) and a Strict gang that rolls back, and a second cycle after a node
is removed; the others are one chunk (``solve``), a cost transformer
(``_dispatch_pipelined`` and ``assign(cost_transform=)``), and the
fallback ladder's levels 1 (with the transformer, so the reference's
compiled programs are shared) and 2. A fault of the port's kernels is
never absorbed by the ladder. The committed seam golden
(``tests/data/torch_golden_seam.npz``) holds the reference's digests of
the scanned run's first cycle, and the port must reproduce them. The
copied host modules must be byte-identical to their origins.
Tolerance: none.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.api import extension as ext
from koordinator_tpu_torch.scheduler import batch_solver as TB
from tools import make_torch_golden

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

ROOT = Path(__file__).resolve().parent.parent
N_NODES, N_PODS, BUCKET = make_torch_golden.SEAM_SMALL
PORT = chip_smoke.port_modules()
#: the host modules the port copies byte for byte
COPIED = (
    "api/__init__.py", "api/extension.py", "api/types.py", "utils/__init__.py",
    "utils/features.py", "utils/metrics.py", "chaos/__init__.py", "chaos/injector.py",
    "core/__init__.py", "core/topology.py", "core/snapshot.py", "core/integrity.py",
    "core/journal.py", "obs/__init__.py", "obs/decisions.py", "obs/errors.py",
    "obs/flightrecorder.py", "obs/health.py", "obs/lifecycle.py", "obs/rejections.py",
    "obs/shadow.py", "obs/slo.py", "obs/trace.py", "runtime/__init__.py",
    "runtime/containment.py", "scheduler/__init__.py", "scheduler/frameworkext.py",
    "scheduler/prebind.py", "scheduler/plugins/__init__.py",
    "scheduler/plugins/coscheduling.py", "scheduler/plugins/elasticquota.py",
    "scheduler/plugins/reservation.py", "scheduler/plugins/deviceshare.py",
    "scheduler/plugins/nodenumaresource.py", "scheduler/plugins/preemption.py",
)


def run_both(bucket=BUCKET, selectors=False, gang=0, transform=False, level=0, second=None):
    """Each package's outcomes of the recipe's cycle, with its scheduler.
    With ``second`` set to a ladder level, a second cycle follows at that
    level on the leftovers and a wave of 200 new pods, after node
    ``n00005`` is removed (200, so that the scanned run's second cycle
    has the first one's chunks and reuses the reference's compiled
    program)."""
    runs = {}
    for name, mods, dev in (("jax", make_torch_golden.reference_modules(), None),
                            ("port", PORT, "cpu")):
        sched = chip_smoke.production_scheduler(mods, N_NODES, N_PODS, bucket, device=dev,
                                                selectors=selectors)
        if transform:
            sched.extender.register_cost_transformer(
                make_torch_golden.seam_transform_jax if name == "jax"
                else chip_smoke.seam_transform)
        sched._fallback_level = level
        out = sched.schedule(chip_smoke.production_pods(mods, N_PODS, selectors=selectors,
                                                        gang=gang))
        outcomes = [chip_smoke.seam_outcome(ext, out)]
        assert sched._fallback_level == level and not sched._cycle_solver_failed, name
        if second is not None:
            sched.snapshot.remove_node("n00005")
            sched._fallback_level = second
            wave = chip_smoke.production_pods(mods, 200, prefix="w2-", owner=False)
            outcomes.append(chip_smoke.seam_outcome(
                ext, sched.schedule(list(out.unschedulable) + wave)))
            assert sched._fallback_level == second and not sched._cycle_solver_failed, name
        runs[name] = (outcomes, sched)
    return runs


def assert_same(runs):
    want, got = runs["jax"][0], runs["port"][0]
    for cycle, (w, g) in enumerate(zip(want, got)):
        assert w["unschedulable"] == g["unschedulable"], cycle
        diff = [(a, b) for a, b in zip(w["bound"], g["bound"]) if a != b]
        assert w["bound"] == g["bound"], (cycle, diff[:3])
    return want


@pytest.fixture(scope="module")
def scanned():
    """The scanned run (``make_torch_golden.SEAM_SMALL_CASE``: node
    selectors and a Strict gang of 70) and its second cycle, on both
    sides."""
    return run_both(second=0, **make_torch_golden.SEAM_SMALL_CASE)


@pytest.fixture(scope="module")
def transformed():
    """The cost-transformer run on both sides, and its second cycle at
    the fallback ladder's level 1 (the per-chunk route, taken directly;
    the reference's compiled programs of the first cycle serve it)."""
    return run_both(transform=True, second=1)


def test_scanned_path_matches_reference_and_golden(scanned):
    outcome = assert_same(scanned)[0]
    assert len(outcome["bound"]) > 100
    assert any(b[2] for b in outcome["bound"]) and any(b[3] for b in outcome["bound"])
    assert any("dry-resv" in b[4] for b in outcome["bound"])
    golden = make_torch_golden.seam_digest_arrays("small", chip_smoke.seam_digest(outcome))
    with np.load(chip_smoke.GOLDEN_SEAM) as f:
        for key, value in golden.items():
            np.testing.assert_array_equal(f[key], value, err_msg=key)
    sched = scanned["port"][1]
    assert sched._resident_nodes.allocatable.device.type == "cpu"


def test_single_chunk_matches_reference():
    assert_same(run_both(bucket=256))


def test_node_selectors_match_reference(scanned):
    outcome = assert_same(scanned)[0]
    on_b = {b[0]: int(b[1][1:]) % 2 for b in outcome["bound"]}
    assert all(on_b[name] == 1 for name in on_b if name.startswith("gpu") and
               int(name[3:]) % 5 == 0)


def test_strict_gang_rolls_back_as_in_reference(scanned):
    outcome = assert_same(scanned)[0]
    assert sum(name.startswith("gang") for name in outcome["unschedulable"]) == 70


def test_cost_transformer_matches_reference(transformed):
    outcome = assert_same(transformed)[0]
    # the transform vetoes node 0 (n % 97 == 0) for every pod the solver
    # places (the reservation's owner binds to its reservation)
    assert all(b[1] != "n00000" for b in outcome["bound"] if b[0] != "owner")


@pytest.mark.parametrize("level", [1, 2])
def test_fallback_ladder_levels_match_reference(level, transformed):
    """Level 1: the transformer run's second cycle. Level 2: a cycle
    through the host reference."""
    if level == 1:
        outcome = assert_same(transformed)[1]
    else:
        (outcome,) = assert_same(run_both(level=level))
    assert outcome["bound"] and outcome["unschedulable"] or level == 2


def test_second_cycle_after_a_node_is_removed(scanned):
    outcomes = assert_same(scanned)
    assert len(outcomes[1]["bound"]) > 0
    assert all(b[1] != "n00005" for b in outcomes[1]["bound"])


@pytest.mark.parametrize("fault", ["kernel", "launch_refused", "card", "lowering"])
def test_the_ladder_absorbs_no_kernel_fault(monkeypatch, fault):
    """A fault of the port's kernels or of the card propagates out of the
    cycle with the ladder left at level 0 and nothing counted; any other
    dispatch fault still moves the cycle down the ladder."""
    exc = {"kernel": kernels.KernelError("nominate: CUDA error 1 (invalid argument)"),
           "launch_refused": kernels.KernelArgumentError("round_tail: D=9 must be in 1..8"),
           "card": torch.AcceleratorError("CUDA error: an illegal memory access"),
           "lowering": RuntimeError("a lowering fault")}[fault]

    def dispatch(*_a, **_k):
        raise exc

    sched = chip_smoke.production_scheduler(PORT, 24, 120, 32, device="cpu")
    monkeypatch.setattr(sched, "_dispatch_scanned", dispatch)
    counter = sched.extender.registry.get("solver_fallback_total")
    pods = chip_smoke.production_pods(PORT, 120)
    if fault == "lowering":
        out = sched.schedule(pods)
        assert sched._fallback_level == 1 and counter.value(level="1") == 1.0
        assert out.bound
        return
    with pytest.raises(type(exc)):
        sched.schedule(pods)
    assert sched._fallback_level == 0 and not sched._cycle_solver_failed
    assert counter.value(level="1") == 0.0 and counter.value(level="2") == 0.0


def test_device_defaults_to_cuda_and_mesh_and_chained_dispatch_are_refused():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TB.BatchScheduler()
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        TB.BatchScheduler(device="cpu", mesh=object())
    sched = TB.BatchScheduler(device="cpu")
    sched.extender.monitor.stop_background()
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        sched._dispatch_chained([], None)
    params = sched._params
    assert params.score_weights.dtype == torch.float32 and params.score_weights.device.type == "cpu"


@pytest.mark.parametrize("level, transform", [(0, False), (0, True), (2, False)])
def test_the_seam_reads_tensors_only_through_host(monkeypatch, level, transform):
    """On the card ``np.asarray`` of a CUDA tensor raises, so every read
    of a device value must go through ``batch_solver._host``: here
    ``np.asarray`` of any tensor raises, on the scanned, transformer and
    host-reference paths, with the rejection classifier's reads."""
    def refuse(self, *a, **k):
        raise TypeError("a tensor read through np.asarray")

    sched = chip_smoke.production_scheduler(PORT, 24, 120, 32, device="cpu")
    if transform:
        sched.extender.register_cost_transformer(chip_smoke.seam_transform)
    sched._fallback_level = level
    pods = chip_smoke.production_pods(PORT, 120, gang=30)
    monkeypatch.setattr(torch.Tensor, "__array__", refuse)
    out = sched.schedule(pods)
    assert not sched._cycle_solver_failed and sched._fallback_level == level
    assert out.bound and out.unschedulable


def test_host_lowering_keeps_the_reference_dtypes():
    assert TB._upload(np.zeros(3), "cpu").dtype == torch.float32
    assert TB._upload(np.zeros(3, np.int64), "cpu").dtype == torch.int32
    for dtype, want in ((np.int8, torch.int8), (np.bool_, torch.bool), (np.int32, torch.int32)):
        assert TB._upload(np.zeros(3, dtype), "cpu").dtype == want
        assert jnp.asarray(np.zeros(3, dtype)).dtype == np.dtype(dtype)


@pytest.mark.parametrize("path", COPIED)
def test_copied_host_module_is_byte_identical(path):
    assert (ROOT / "koordinator_tpu_torch" / path).read_bytes() == \
        (ROOT / "koordinator_tpu" / path).read_bytes()
