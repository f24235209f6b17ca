"""tpu_slam_torch — the PyTorch + CUDA port of ``tpu_slam``.

Same public names and packed result contracts as the JAX package; plain
tensor code is PyTorch, and each Pallas TPU kernel on the ported path is a
hand-written CUDA kernel under ``csrc/``. A tensor on ``cuda`` runs the
kernel, a tensor on ``cpu`` runs the kernel's plain PyTorch version
(``_dispatch.route``). The entry points that make tensors put them on
``_dispatch.DEFAULT_DEVICE``, the card, unless given ``device="cpu"``.
The package imports nothing of ``tpu_slam``: the host modules it needs
(config, geometry_np, data/simulator, solver/banded, utils/evaluation,
utils/profiling, utils/events, utils/checkpoint) are its own copies.
"""
