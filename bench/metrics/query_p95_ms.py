"""95th percentile of every window query's latency (host clock from the
call to its synchronised end): the wait per answer."""
from bench.yardstick import percentile


def read(run):
    if not run.queries:
        return None
    return percentile([q.ms for q in run.queries], 95)
