"""encode_rows_s: rows labelled over the window's seconds."""


def read(run):
    jobs = run["window"]["jobs"]
    if not jobs or "rows" not in jobs[0]:
        return None
    return sum(j["rows"] for j in jobs) / run["window"]["seconds"]
