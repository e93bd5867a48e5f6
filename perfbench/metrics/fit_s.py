"""fit_s: the window's seconds over the jobs (fit + full-data evaluate)
completed in it."""


def read(run):
    jobs = run["window"]["jobs"]
    if not jobs or "fit_s" not in jobs[0]:
        return None
    return run["window"]["seconds"] / len(jobs)
