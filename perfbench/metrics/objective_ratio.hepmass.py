"""objective_ratio.hepmass: objective_ratio (metrics/objective_ratio.py,
read by the same reader) in the paper's cells, where it spreads wider
(merged components come and go from job to job) and has a bound of its
own."""
from perfbench import cells

read = cells.reader("objective_ratio")
