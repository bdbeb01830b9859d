"""Set-up: from the process's start to the window's start (loading, weights
made on the device, kernels built or found built, warm-up)."""


def read(rec):
    return rec["setup_s"]
