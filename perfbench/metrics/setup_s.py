"""Set-up seconds: from the process's start to the window's (build,
inputs, weights, warm-up and captures)."""


def read(rec):
    return rec["setup_s"]
