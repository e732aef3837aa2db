"""Rows past the metadata filter, over all the window's queries, per
second of the whole window (host clock): query time at fixed cascades."""


def read(run):
    if not run.queries or run.window_s <= 0:
        return None
    return sum(q.rows_scanned for q in run.queries) / run.window_s
