"""join_rows_per_s: the input rows, build plus probe, of every join the
window completed, over the whole window's host clock."""


def read(r):
    return sum(r.rows) / r.window_s
