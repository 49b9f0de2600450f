"""setup_s: seconds from the process's start to the window's: the kernel
library loaded (built on a checkout's first run), the weights drawn, the
engine built and warmed."""


def read(run):
    return run.setup_s
