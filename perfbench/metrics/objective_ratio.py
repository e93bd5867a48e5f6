"""objective_ratio: the sum over the window's jobs of the full-data
objective that evaluate returned, over the same number of times the
objective of the generator's true component means."""


def read(run):
    jobs = run["window"]["jobs"]
    if not jobs or run.get("f_true") is None:
        return None
    return sum(j["f"] for j in jobs) / (len(jobs) * run["f_true"])
