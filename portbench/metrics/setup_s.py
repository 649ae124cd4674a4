"""setup_s (s): from the process's start to the end of the warm-up:
imports, the CUDA context, the kernel's build where it is not yet built,
the problem made on the card, and the mix's warm solves at the cell's n."""


def read(run):
    return run.setup_s
