"""idle_share.encode: idle_share.fit's reading (metrics/idle_share.fit.py,
read by the same reader) in the encode cells, beside the encode_rows_s it
moves."""
from perfbench import cells

read = cells.reader("idle_share.fit")
