"""The examples — the port's counterparts of the JAX package's
``examples/`` scripts, with their options, recipes and printed lines:

    python -m tpu_slam_torch.examples.run_karto_slam [--cpu] [--no-loop]
    python -m tpu_slam_torch.examples.run_hector_slam --scans 150

Each example is three functions: ``recipe(cfg, device, ...)`` makes its
inputs, ``run(...)`` computes the figures it prints and returns them in a
dict, and ``main(argv=None)`` parses the options, prints the reference
example's lines and returns the figures. An example runs on the CUDA card,
or on the CPU with ``--cpu``; without ``--cpu`` and without a card it
stops with an error and does not carry on on the CPU.
"""

from __future__ import annotations

import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE


def device_of(cpu: bool) -> str:
    """The device an example runs on: the card, or the CPU with ``--cpu``;
    with no card and no ``--cpu`` it raises."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the example runs on the card; pass --cpu to run "
            "it on the CPU")
    return DEFAULT_DEVICE
