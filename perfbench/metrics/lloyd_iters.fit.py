"""lloyd_iters.fit: Lloyd iterations a chunk over the window's fits
(FitResult.n_iterations / n_chunks)."""


def read(run):
    jobs = run["window"]["jobs"]
    chunks = sum(j.get("n_chunks", 0) for j in jobs)
    if not chunks:
        return None
    return sum(j["n_iterations"] for j in jobs) / chunks
