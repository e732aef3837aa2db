"""ScanStats' rows evaluated (every stage's rows run through its
cascade) over rows scanned, summed over the window's queries: how much
of each later predicate's work the earlier ones remove."""


def read(run):
    scanned = sum(q.rows_scanned for q in run.queries)
    if not scanned:
        return None
    return sum(q.rows_evaluated for q in run.queries) / scanned
