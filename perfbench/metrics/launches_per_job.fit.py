"""launches_per_job.fit: the port's kernel launches a job (the sum of
repro_torch.kernels.ops.launch_counts(), reset before each job)."""


def read(run):
    jobs = run["window"]["jobs"]
    if not jobs or "fit_s" not in jobs[0]:
        return None
    return sum(j["launches"] for j in jobs) / len(jobs)
