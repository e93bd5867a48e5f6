"""idle_share.fit: the share of the traced jobs' untraced time in which no
kernel, copy or memset ran on the card, in %.  The busy time is the
traced jobs' (a torch.profiler that records only the card's activity);
the time is the same jobs' in the untraced window (the traced jobs replay
the window's first jobs, seed for seed), since the profiler slows the
host's launches."""


def read(run):
    tr = run.get("traced")
    if not tr or not tr.get("untraced_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["untraced_s"])
