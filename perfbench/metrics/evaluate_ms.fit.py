"""evaluate_ms.fit: the mean host-clock milliseconds of a job's
full-data evaluate (ending in a device synchronize), over the window."""


def read(run):
    jobs = run["window"]["jobs"]
    if not jobs or "fit_s" not in jobs[0]:
        return None
    return 1e3 * sum(j["evaluate_s"] for j in jobs) / len(jobs)
