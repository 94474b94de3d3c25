"""join_rows_per_s: the input rows of every op the window completed (the
configuration's generator's ``rows``: build plus probe for a join), over
the whole window's host clock."""


def read(r):
    return sum(r.rows) / r.window_s
