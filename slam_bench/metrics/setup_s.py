"""Set-up: from the process's start to the window's (imports, the CUDA
context, the kernels loaded or built, the pool drawn, the warm-up)."""


def read(run):
    return run.setup_s
