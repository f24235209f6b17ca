"""``python -m tpu_slam_torch <model> [options]`` (see ``cli.py``)."""

from tpu_slam_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
