"""``setup_s``: process start to the first timed request (imports, kernel
load or build, the host library, input files, scene build, warm-up)."""


def read(run):
    return run.setup_s
