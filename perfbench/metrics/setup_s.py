"""setup_s: seconds from the process's start to its first timed job."""


def read(run):
    return run["setup_s"]
