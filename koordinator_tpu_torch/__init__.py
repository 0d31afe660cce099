"""PyTorch/CUDA port of ``koordinator_tpu``'s LoadAware batch solver.

The port sits beside the JAX package and keeps its module and function
names (``ops/masks.py``, ``ops/costs.py``, ``ops/solver.py``), so each
counterpart is easy to find. It imports ``torch`` and ``numpy`` only: no
``jax`` and nothing of ``koordinator_tpu``.

Device rule: constructors take ``device=`` and default to ``cuda``. Without
a card they raise unless the caller passes ``device="cpu"``; there is no
silent CPU fallback. Functions work on whatever device their tensors live
on: on a CUDA tensor a kernel wrapper launches its hand-written kernel
(``csrc/*.cu``), on a CPU tensor it runs the kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device a constructor places its tensors on: ``cuda`` unless the
    caller names another. Asking for CUDA where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "koordinator_tpu_torch defaults to device='cuda', and CUDA is not "
            "available here; pass device='cpu' to run on the CPU"
        )
    return dev
