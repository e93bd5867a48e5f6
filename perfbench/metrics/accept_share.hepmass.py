"""accept_share.hepmass: accept_share (metrics/accept_share.py, read by
the same reader) in the paper's cells, beside the objective_ratio.hepmass
it moves."""
from perfbench import cells

read = cells.reader("accept_share")
