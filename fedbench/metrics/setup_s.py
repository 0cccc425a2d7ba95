"""setup_s: seconds from the run's start to the window's: loading,
drawing the inputs, building the program's state, the warm-up (and, on a
checkout's first run, the kernels' build)."""


def read(run):
    return run["setup_s"]
