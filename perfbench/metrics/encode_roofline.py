"""encode_roofline: the least time of the traced evaluate calls' work (a
full-data assignment each) in % of the card's busy time in them."""
from perfbench.gen import roofline as rl


def read(run):
    tr = run.get("traced")
    if not tr or not tr["busy_s"] or "rows" not in tr["jobs"][0]:
        return None
    c = run["config"]
    least = len(tr["jobs"]) * rl.evaluate_least_seconds(
        m=c["m"], n=c["n"], k=c["k"],
        peak_flops=rl.COMPUTE_PEAK[c["precision"]])
    return 100.0 * least / tr["busy_s"]
