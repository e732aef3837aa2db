"""The fused pyramid and stage-0 kernel's share of its roofline: the
least time one chunk's work could take on the card (bench/yardstick's
bytes and operations from the configuration's shapes, over the published
peaks) over the device time of the ``ps0_*`` kernels a launch (one
launch: one ``ps0_pool_kernel``)."""
from bench.yardstick import bound_s, peaks, stage0_work

PREFIX = "ps0_"
FIRST = "ps0_pool_kernel"


def out_levels(cfg) -> list:
    """Pooled levels below the base that both the first predicate and a
    later one read: what a chunk's stage 0 must hand on."""
    base = int(cfg["base"])
    preds = cfg["predicates"]
    first = {int(l["res"]) for l in preds[0]["levels"]}
    later = {int(l["res"]) for p in preds[1:] for l in p["levels"]}
    return sorted((first & later) - {base})


def read(run):
    tr = run.trace
    if tr is None:
        return None
    times = tr.time_by_name()
    launches = sum(v[0] for n, v in times.items() if n.startswith(FIRST))
    t = sum(v[1] for n, v in times.items() if n.startswith(PREFIX))
    if not launches or t <= 0:
        return None
    pk = peaks(run.device_kind)
    if pk is None:
        return None
    cfg = run.data["config"]
    l0 = cfg["predicates"][0]["levels"][0]
    nbytes, ops = stage0_work(int(cfg["chunk"]), int(cfg["base"]),
                              out_levels(cfg),
                              (tuple(l0["arch"]), int(l0["res"]),
                               l0["color"]))
    return 100.0 * bound_s(nbytes, ops, pk) / (
        t / launches)
