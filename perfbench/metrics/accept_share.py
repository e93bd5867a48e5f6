"""accept_share: chunks whose solution was accepted, in % of the chunks
of the window's fits (FitResult.n_accepted / n_chunks)."""


def read(run):
    jobs = run["window"]["jobs"]
    chunks = sum(j.get("n_chunks", 0) for j in jobs)
    if not chunks:
        return None
    return 100.0 * sum(j["n_accepted"] for j in jobs) / chunks
