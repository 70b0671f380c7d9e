"""setup_s: seconds from the process's start to the end of set-up (torch,
the kernel libraries, the model and its weights, the pool of batches,
the first steps)."""


def read(ctx, name):
    return ctx["setup_s"]
