"""The one dispatch rule of the port, and the kernels' launch counters.

A tensor on ``cuda`` goes to the hand-written kernel; a tensor on ``cpu``
goes to the kernel's plain PyTorch version; any other device raises. This
replaces the JAX package's backend checks (``jax.default_backend() ==
"tpu"`` in ``parallel/distributed_step._match_fn`` and
``solver/pose_graph.PoseGraphSolver.compute_async``): the device of the
data decides, and there is no silent fallback from the kernel.

``DEFAULT_DEVICE`` is the device of every entry point that makes tensors
(``PoseGraphSolver``, ``make_scan``, ``HectorSLAM``, ``KartoSLAM``, the
odometry models and the ``convert`` functions) unless the caller passes
another: the card. A caller who wants the CPU passes ``device="cpu"``;
nothing looks for a GPU and carries on without one.

``LAUNCHES`` holds one plain integer per kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""

from __future__ import annotations

import functools

import torch

DEFAULT_DEVICE = "cuda"

LAUNCHES: dict[str, int] = {
    "plicp_fused": 0, "cr_lm": 0, "cr_stream": 0, "pcg_lm": 0,
    "hector_fused": 0, "correlative_response": 0, "nn": 0,
}


def route(t: torch.Tensor) -> str:
    """``"cuda"`` (launch the kernel) or ``"cpu"`` (plain version)."""
    kind = t.device.type
    if kind in ("cuda", "cpu"):
        return kind
    raise ValueError(f"no kernel or plain route for device {t.device}")


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev``, on which a kernel's launch
    geometry depends."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
