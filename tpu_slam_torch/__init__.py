"""tpu_slam_torch — the PyTorch + CUDA port of ``tpu_slam``.

Same public names and packed result contracts as the JAX package; plain
tensor code is PyTorch, and each Pallas TPU kernel on the ported path is a
hand-written CUDA kernel under ``csrc/``. A tensor on ``cuda`` runs the
kernel, a tensor on ``cpu`` runs the kernel's plain PyTorch version
(``_dispatch.route``).
"""
