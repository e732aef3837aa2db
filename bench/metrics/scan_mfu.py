"""The whole query's share of the card's peak over the window: the larger
of the CNN FLOPs the answers need (rows reaching each level by the
reference, times bench/yardstick's ``cnn_flops``) over the f32 FFMA peak
and the base frames read once over HBM bandwidth, over the window's host
time."""
from bench.yardstick import F32, channels, cnn_flops, peaks


def read(run):
    if not run.queries or run.window_s <= 0:
        return None
    cfg = run.data["config"]
    pk = peaks(run.device_kind)
    if pk is None:
        return None
    per_cam = {}
    for cam, reach in run.data["reach"].items():
        per_cam[cam] = sum(
            n * cnn_flops(tuple(l["arch"]), int(l["res"]),
                          channels(l["color"]))
            for pred, counts in zip(cfg["predicates"], reach)
            for l, n in zip(pred["levels"], counts))
    flops = sum(per_cam[q.cam] for q in run.queries)
    base = int(cfg["base"])
    nbytes = sum(q.rows_scanned for q in run.queries) * base * base * 3 * F32
    return 100.0 * max(flops / pk.f32_flops, nbytes / pk.hbm_bw) \
        / run.window_s
