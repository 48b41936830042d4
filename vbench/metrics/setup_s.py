"""setup_s: from the process's start to the first timed request: kernel
build or load, inputs, the system's build, warm-up."""


def read(run):
    return run.setup_s
