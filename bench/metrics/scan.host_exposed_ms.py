"""Mean over the traced queries of the benchmark's span around
``execute`` less the device's busy time inside it: host time the device
does not hide."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels or not tr.spans:
        return None
    exposed = [(e - s) / 1e6 - tr.busy_in(s, e) * 1e3 for s, e in tr.spans]
    return sum(exposed) / len(exposed)
