"""fit_roofline: the least time the traced jobs' Lloyd and evaluate work
needs on the card, in % of the card's busy time in them.

The work is counted from the shapes and the program's own iteration
counts (perfbench.gen.roofline), whatever kernels do it; the peak is
COMPUTE_PEAK of the configuration's precision."""
from perfbench.gen import roofline as rl


def read(run):
    tr = run.get("traced")
    if not tr or not tr["busy_s"] or "n_iterations" not in tr["jobs"][0]:
        return None
    c = run["config"]
    peak = rl.COMPUTE_PEAK[c["precision"]]
    least = sum(
        rl.fit_least_seconds(s=c["s"], n=c["n"], k=c["k"],
                             n_chunks=j["n_chunks"],
                             n_iterations=j["n_iterations"], peak_flops=peak)
        + rl.evaluate_least_seconds(m=c["m"], n=c["n"], k=c["k"],
                                    peak_flops=peak)
        for j in tr["jobs"])
    return 100.0 * least / tr["busy_s"]
