"""Cascade construction + evaluation (paper §V-D/E).

The paper's key evaluation trick: inference runs ONCE per model over the
eval split; every cascade is then *simulated* from the cached score matrix.
We push this further than the paper's per-cascade loop: because decision
thresholds are per-model (independent of cascade context, §V-C), cascade
accuracy/cost decompose into per-model sums and pairwise inner products
over images — so evaluating ALL 1/2/3-level cascades is a handful of
(A x I) @ (I x B) matmuls (DESIGN.md §3).

Two evaluators share the same closed form:

  evaluate_cascades            dense numpy (a copy of the reference's):
                               materializes the full (A2,M) and (A,B)
                               blocks in host RAM.
  evaluate_cascades_streaming  bounded memory: the A axis is processed in
                               fixed-size chunks of torch tensors on the
                               device (inner products through the
                               hand-written kernels/matmul.py kernel on a
                               card), each chunk immediately folded into
                               a streaming Pareto-frontier / top-K
                               reduction — the full N-cascade arrays are
                               never materialized (DESIGN.md §3).

Cascade semantics (Def. 7): image flows through levels; level l's output o
is accepted iff o <= p_low or o >= p_high (label = o >= p_high); the final
level's label is o >= 0.5 unconditionally.

Cost semantics (§VI + §VII-A3): expected seconds/image =
  sum_l P(reach l) * [infer_s(l) + rep-handling of level-l's representation
                      if not already materialized by an earlier level]
with rep handling priced by the deployment scenario (core/costs.py).
Pyramid pricing (default): a follow-up representation is transformed from
the nearest already-materialized pyramid level instead of the raw base
image — the incremental t_transform of core/transforms.plan_pyramid,
mirroring what core/executor.py actually executes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.costs import CostProfile, rep_cost_s
from repro_torch.core.transforms import Representation

KIND_SINGLE, KIND_TWO, KIND_THREE = 0, 1, 2


@dataclass
class CascadeSpace:
    """Flat arrays over enumerated (dense) or surviving (streaming)
    cascades. ``evaluated`` counts the cascades scored to produce this
    space (== len() for the dense evaluator)."""
    acc: np.ndarray          # (N,)
    time_s: np.ndarray       # (N,) expected seconds/image
    kind: np.ndarray         # (N,) 0/1/2
    i1: np.ndarray           # (N,) level-1: configured idx (kinds 1,2) or model idx (kind 0)
    i2: np.ndarray           # (N,) level-2: model idx (kind 1) / configured idx (kind 2)
    n_targets: int
    trusted: int
    evaluated: int = 0

    @property
    def throughput(self) -> np.ndarray:
        return 1.0 / self.time_s

    def __len__(self):
        return len(self.acc)

    def describe(self, i: int, model_names: Sequence[str],
                 targets: Sequence[float]) -> str:
        k = self.kind[i]
        def cfg(a):
            return (f"{model_names[a // self.n_targets]}"
                    f"@p{targets[a % self.n_targets]}")
        if k == KIND_SINGLE:
            return model_names[self.i1[i]]
        if k == KIND_TWO:
            return f"{cfg(self.i1[i])} -> {model_names[self.i2[i]]}"
        return (f"{cfg(self.i1[i])} -> {cfg(self.i2[i])} -> "
                f"{model_names[self.trusted]}")


# ------------------------------------------------------------ cost model ---
def _cost_matrices(reps: list[Representation], infer_s, profile,
                   scenario: str, trusted: int, pyramid: bool):
    """first[m]  : level-1 cost of model m (rep-from-base + infer).
    follow[i,j]  : data cost of rep_j at the level after a level using
                   rep_i (materialized pyramid levels: {base, res_i}).
    tpair[i,j]   : data cost of the trusted rep at level 3 after levels
                   using rep_i then rep_j ({base, res_i, res_j})."""
    m = len(reps)
    res = np.array([r.resolution for r in reps])
    names = np.array([r.name for r in reps])
    same = names[:, None] == names[None, :]

    first = np.array([rep_cost_s(profile, reps[i], scenario, True)
                      + infer_s[i] for i in range(m)])

    uniq = sorted(set(int(r) for r in res))
    # cost_from[u][j]: rep_j produced from a materialized level at u
    cost_from = {u: np.array([rep_cost_s(profile, reps[j], scenario, False,
                                         source_hw=u if pyramid else None)
                              for j in range(m)]) for u in uniq}
    cost_base = np.array([rep_cost_s(profile, reps[j], scenario, False)
                          for j in range(m)])

    div = (res[:, None] % res[None, :]) == 0          # src i usable for j
    by_src = np.stack([cost_from[int(r)] for r in res])   # (m_src, m)
    follow = np.where(div, by_src, cost_base[None, :])
    follow[same] = 0.0

    rt = reps[trusted]
    big = np.iinfo(np.int64).max
    src_t = np.where((res % rt.resolution == 0) if pyramid
                     else np.zeros(m, bool), res, big)   # (m,) or sentinel
    pair_src = np.minimum(src_t[:, None], src_t[None, :])  # (m, m)
    t_by_src = {u: rep_cost_s(profile, rt, scenario, False, source_hw=u)
                for u in uniq}
    t_base = rep_cost_s(profile, rt, scenario, False)
    tpair = np.full((m, m), t_base)
    for u in uniq:
        tpair[pair_src == u] = t_by_src[u]
    tpair[same[:, trusted][:, None] | same[trusted, :][None, :]] = 0.0
    return first, follow, tpair


def _certainty_stats(scores, truth, p_low, p_high):
    """Per-configured-model certainty/correctness reductions shared by both
    evaluators. Returns dict of (A,I)/(A,)/(M,)-shaped arrays."""
    s = np.asarray(scores, np.float32)
    y = np.asarray(truth, bool)
    m_models, n_img = s.shape
    p_low = np.asarray(p_low)
    p_high = np.asarray(p_high)
    n_t = p_low.shape[1]
    shi = s[:, None, :] >= p_high[:, :, None]          # (M,T,I)
    slo = s[:, None, :] <= p_low[:, :, None]
    cert = (shi | slo)
    corr_cert = cert & (shi == y[None, None, :])
    a_dim = m_models * n_t
    c = cert.reshape(a_dim, n_img).astype(np.float32)           # (A,I)
    v = corr_cert.reshape(a_dim, n_img).astype(np.float32)      # (A,I)
    corr_final = ((s >= 0.5) == y[None, :]).astype(np.float32)  # (M,I)
    return {
        "c": c, "v": v, "cc_sum": v.sum(1), "p_cert": c.mean(1),
        "c_sum": c.sum(1), "corr_final": corr_final,
        "cf_sum": corr_final.sum(1), "n_img": n_img,
        "m_models": m_models, "n_t": n_t,
        "cfg_model": np.repeat(np.arange(m_models), n_t),
    }


# --------------------------------------------------------- dense evaluator -
def evaluate_cascades(scores_eval, truth, p_low, p_high,
                      reps: list[Representation], infer_s,
                      profile: CostProfile, scenario: str,
                      trusted: int, *, max_level: int = 3,
                      first_level_models=None,
                      pyramid: bool = True) -> CascadeSpace:
    """scores_eval (M, I); p_low/p_high (M, T); infer_s (M,).
    trusted: model index used as the forced final level of 3-level
    cascades (the paper's ResNet50 slot). pyramid: price follow-up
    transforms incrementally from materialized pyramid levels (see module
    docstring); False reproduces from-base pricing."""
    st = _certainty_stats(scores_eval, truth, p_low, p_high)
    m_models, n_img, n_t = st["m_models"], st["n_img"], st["n_t"]
    c, v, corr_final = st["c"], st["v"], st["corr_final"]
    cc_sum, p_cert, cf_sum = st["cc_sum"], st["p_cert"], st["cf_sum"]
    cfg_model = st["cfg_model"]
    infer_s = np.asarray(infer_s, np.float64)
    first_c, follow_c, tpair_c = _cost_matrices(
        reps, infer_s, profile, scenario, trusted, pyramid)

    first_models = (np.arange(m_models) if first_level_models is None
                    else np.asarray(first_level_models))

    out_acc, out_t, out_kind, out_i1, out_i2 = [], [], [], [], []

    # ---- 1-level: every base model alone
    out_acc.append(cf_sum / n_img)
    out_t.append(first_c.copy())
    out_kind.append(np.full(m_models, KIND_SINGLE))
    out_i1.append(np.arange(m_models))
    out_i2.append(np.full(m_models, -1))

    if max_level >= 2:
        # ---- 2-level: configured a -> final b (all models)
        a_idx = (first_models[:, None] * n_t
                 + np.arange(n_t)[None, :]).ravel()             # (A2,)
        c_a = c[a_idx]
        acc = (cc_sum[a_idx][:, None] + cf_sum[None, :]
               - c_a @ corr_final.T) / n_img                    # (A2,M)
        p_unc = 1.0 - p_cert[a_idx]
        rep_extra = follow_c[cfg_model[a_idx]]                  # (A2,M)
        t = (first_c[cfg_model[a_idx]][:, None]
             + p_unc[:, None] * (infer_s[None, :] + rep_extra))
        a2, mm = acc.shape
        out_acc.append(acc.ravel())
        out_t.append(t.ravel())
        out_kind.append(np.full(a2 * mm, KIND_TWO))
        out_i1.append(np.repeat(a_idx, mm))
        out_i2.append(np.tile(np.arange(m_models), a2))

    if max_level >= 3:
        # ---- 3-level: configured a -> configured b -> trusted
        a_idx = (first_models[:, None] * n_t
                 + np.arange(n_t)[None, :]).ravel()
        b_idx = np.arange(m_models * n_t)
        c_a, c_b = c[a_idx], c
        corr_t = corr_final[trusted]
        ct_sum = corr_t.sum()
        term2 = cc_sum[None, :] - c_a @ v.T                     # (A,B)
        cab = c_a @ c_b.T
        cab_t = (c_a * corr_t[None, :]) @ c_b.T
        sum_ca_t = c_a @ corr_t
        sum_cb_t = c_b @ corr_t
        term3 = (ct_sum - sum_ca_t[:, None] - sum_cb_t[None, :] + cab_t)
        acc = (cc_sum[a_idx][:, None] + term2 + term3) / n_img
        p_unc_a = 1.0 - p_cert[a_idx]
        p_unc_ab = (n_img - c_a.sum(1)[:, None] - c_b.sum(1)[None, :]
                    + cab) / n_img
        mb = cfg_model
        ma = cfg_model[a_idx]
        rep_b_extra = follow_c[ma][:, mb]
        rep_t_extra = tpair_c[ma][:, mb]
        t = (first_c[ma][:, None]
             + p_unc_a[:, None] * (infer_s[mb][None, :] + rep_b_extra)
             + p_unc_ab * (infer_s[trusted] + rep_t_extra))
        a3, bdim = acc.shape
        out_acc.append(acc.ravel())
        out_t.append(t.ravel())
        out_kind.append(np.full(a3 * bdim, KIND_THREE))
        out_i1.append(np.repeat(a_idx, bdim))
        out_i2.append(np.tile(b_idx, a3))

    acc = np.concatenate(out_acc)
    return CascadeSpace(
        acc=acc, time_s=np.concatenate(out_t),
        kind=np.concatenate(out_kind).astype(np.int8),
        i1=np.concatenate(out_i1).astype(np.int32),
        i2=np.concatenate(out_i2).astype(np.int32),
        n_targets=n_t, trusted=trusted, evaluated=len(acc))


# ----------------------------------------------------- streaming evaluator -
def _frontier_mask(acc, time_s):
    """Vectorized (acc max, time min) skyline sweep — O(n log n), no
    python-per-point loop. May keep boundary duplicates; the final result
    is canonicalized through pareto.pareto_indices by the caller."""
    acc = np.asarray(acc, np.float64)
    thr = 1.0 / np.asarray(time_s, np.float64)
    order = np.lexsort((-thr, -acc))
    t_sorted = thr[order]
    keep_sorted = np.empty(len(order), bool)
    if len(order):
        keep_sorted[0] = True
        keep_sorted[1:] = t_sorted[1:] > np.maximum.accumulate(t_sorted)[:-1]
    mask = np.zeros(len(acc), bool)
    mask[order[keep_sorted]] = True
    return mask


class _StreamReducer:
    """Folds candidate blocks into a bounded survivor set: the running
    Pareto frontier, or a top-K (by accuracy, faster-first tie-break).
    Peak state is O(frontier + K), independent of cascades seen.

    Pareto fold cost per block is O(n log F): a vectorized dominance test
    against the current frontier (searchsorted + suffix-max) discards the
    overwhelming majority of candidates WITHOUT sorting the block; only
    the (few) non-dominated survivors pay the exact skyline sweep."""

    FIELDS = ("acc", "time_s", "kind", "i1", "i2")

    def __init__(self, keep: str = "pareto", top_k: int | None = None):
        assert keep in ("pareto", "topk")
        if keep == "topk" and not top_k:
            raise ValueError("keep='topk' requires top_k")
        self.keep = keep
        self.top_k = top_k
        self.buf = {f: np.empty(0) for f in self.FIELDS}
        self.seen = 0
        # frontier dominance index: acc ascending + suffix max throughput
        self._acc_sorted = np.empty(0)
        self._thr_suffix_max = np.empty(0)

    def _reindex(self):
        order = np.argsort(self.buf["acc"], kind="stable")
        self._acc_sorted = self.buf["acc"][order]
        thr = 1.0 / self.buf["time_s"][order]
        self._thr_suffix_max = np.maximum.accumulate(thr[::-1])[::-1]

    def _undominated(self, acc, thr):
        """True for candidates no current frontier point dominates (exact
        duplicates of frontier points count as dominated)."""
        if not len(self._acc_sorted):
            return np.ones(len(acc), bool)
        idx = np.searchsorted(self._acc_sorted, acc, side="left")
        best = np.full(len(acc), -np.inf)
        inb = idx < len(self._acc_sorted)
        best[inb] = self._thr_suffix_max[idx[inb]]
        return thr > best

    def push(self, acc, time_s, kind, i1, i2):
        acc = np.asarray(acc).ravel()
        self.seen += len(acc)
        time_s = np.asarray(time_s).ravel()
        if self.keep == "pareto":
            thr = 1.0 / time_s
            cand = np.nonzero(self._undominated(acc, thr))[0]
            if not len(cand):
                return
            block = {"acc": acc[cand], "time_s": time_s[cand],
                     "kind": np.broadcast_to(kind, acc.shape)[cand],
                     "i1": np.asarray(i1).ravel()[cand],
                     "i2": np.asarray(i2).ravel()[cand]}
            merged = {f: np.concatenate([self.buf[f], block[f]])
                      for f in self.FIELDS}
            mask = _frontier_mask(merged["acc"], merged["time_s"])
            self.buf = {f: merged[f][mask] for f in self.FIELDS}
            self._reindex()
        else:
            block = {"acc": acc, "time_s": time_s,
                     "kind": np.broadcast_to(kind, acc.shape).ravel(),
                     "i1": np.asarray(i1).ravel(),
                     "i2": np.asarray(i2).ravel()}
            k = self.top_k
            if len(acc) > k:
                # intra-block prefilter: keep everything at or above the
                # k-th largest accuracy (>= keeps boundary TIES, so the
                # faster-first tie-break below still sees all of them)
                kth = np.partition(block["acc"], len(acc) - k)[len(acc) - k]
                mask = block["acc"] >= kth
                block = {f: block[f][mask] for f in self.FIELDS}
            merged = {f: np.concatenate([self.buf[f], block[f]])
                      for f in self.FIELDS}
            order = np.lexsort((merged["time_s"], -merged["acc"]))[:k]
            self.buf = {f: merged[f][order] for f in self.FIELDS}

    def result(self, n_targets: int, trusted: int) -> CascadeSpace:
        from repro_torch.core.pareto import pareto_indices
        buf = self.buf
        if self.keep == "pareto" and len(buf["acc"]):
            idx = np.sort(pareto_indices(buf["acc"], 1.0 / buf["time_s"]))
            buf = {f: buf[f][idx] for f in self.FIELDS}
        return CascadeSpace(
            acc=np.asarray(buf["acc"], np.float64),
            time_s=np.asarray(buf["time_s"], np.float64),
            kind=np.asarray(buf["kind"], np.int8),
            i1=np.asarray(buf["i1"], np.int32),
            i2=np.asarray(buf["i2"], np.int32),
            n_targets=n_targets, trusted=trusted, evaluated=self.seen)


def evaluate_cascades_streaming(scores_eval, truth, p_low, p_high,
                                reps: list[Representation], infer_s,
                                profile: CostProfile, scenario: str,
                                trusted: int, *, max_level: int = 3,
                                first_level_models=None,
                                pyramid: bool = True,
                                chunk: int = 128,
                                keep: str = "pareto",
                                top_k: int | None = None,
                                use_kernel_matmul: bool | None = None,
                                device=None) -> CascadeSpace:
    """Bounded-memory evaluation of the same cascade space as
    ``evaluate_cascades``: first-level configurations are processed in
    ``chunk``-sized slices on ``device`` (the (chunk,M) 2-level and
    (chunk,B) 3-level blocks, f32), and every block is folded into a
    streaming Pareto/top-K reduction before the next slice is computed.
    Peak memory is O(chunk * B + survivors) instead of O(A * B).

    use_kernel_matmul: route the four inner products per chunk through
    kernels/matmul.matmul (the hand-written kernel on a CUDA device, its
    plain version on the CPU); default: True on a CUDA device. False uses
    ``torch.matmul``. ``device`` defaults to ``cuda``."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    st = _certainty_stats(scores_eval, truth, p_low, p_high)
    m_models, n_img, n_t = st["m_models"], st["n_img"], st["n_t"]
    cfg_model = st["cfg_model"]
    infer64 = np.asarray(infer_s, np.float64)
    first_c, follow_c, tpair_c = _cost_matrices(
        reps, infer64, profile, scenario, trusted, pyramid)

    red = _StreamReducer(keep=keep, top_k=top_k)

    # ---- 1-level block (tiny; no chunking needed)
    red.push(st["cf_sum"] / n_img, first_c, KIND_SINGLE,
             np.arange(m_models), np.full(m_models, -1))
    if max_level < 2:
        return red.result(n_t, trusted)

    if use_kernel_matmul is None:
        use_kernel_matmul = dev.type == "cuda"
    if use_kernel_matmul:
        from repro_torch.kernels.matmul import matmul as _kernel_mm

        def mm(a, b):
            return _kernel_mm(a, b, out_dtype=torch.float32)
    else:
        mm = torch.matmul

    def put(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)

    # device-resident constants (A,I)/(M,I): the only full-width state
    c_d = put(st["c"])
    v_t = put(st["v"].T)
    c_t = put(st["c"].T)
    cf_t = put(st["corr_final"].T)
    corr_t = put(st["corr_final"][trusted])
    ct_sum = float(st["corr_final"][trusted].sum())
    cf_sum_d = put(st["cf_sum"])
    cc_sum_d = put(st["cc_sum"])
    c_sum_d = put(st["c_sum"])
    sum_cb_t = put(st["c"] @ st["corr_final"][trusted])
    infer_m = put(infer64)
    infer_b = put(infer64[cfg_model])
    infer_trusted = float(infer64[trusted])
    inv_n = 1.0 / n_img

    def _eval_chunk(ca, cc_a, pc_a, first_a, f2, f3, tp):
        # 2-level (chunk, M)
        acc2 = (cc_a[:, None] + cf_sum_d[None, :] - mm(ca, cf_t)) * inv_n
        t2 = first_a[:, None] + (1.0 - pc_a)[:, None] * (infer_m[None, :]
                                                         + f2)
        if max_level < 3:
            return acc2, t2, None, None
        # 3-level (chunk, B)
        term2 = cc_sum_d[None, :] - mm(ca, v_t)
        cab = mm(ca, c_t)
        cab_t = mm(ca * corr_t[None, :], c_t)
        sum_ca_t = ca @ corr_t
        term3 = ct_sum - sum_ca_t[:, None] - sum_cb_t[None, :] + cab_t
        acc3 = (cc_a[:, None] + term2 + term3) * inv_n
        p_unc_ab = (n_img - ca.sum(1)[:, None] - c_sum_d[None, :]
                    + cab) * inv_n
        t3 = (first_a[:, None]
              + (1.0 - pc_a)[:, None] * (infer_b[None, :] + f3)
              + p_unc_ab * (infer_trusted + tp))
        return acc2, t2, acc3, t3

    first_models = (np.arange(m_models) if first_level_models is None
                    else np.asarray(first_level_models))
    a_idx = (first_models[:, None] * n_t
             + np.arange(n_t)[None, :]).ravel()
    b_idx = np.arange(m_models * n_t)
    chunk = max(1, min(chunk, len(a_idx)))

    # one f32 copy of the per-model cost gathers; chunks slice rows
    first32 = first_c.astype(np.float32)
    follow32 = follow_c.astype(np.float32)               # (M, M)
    follow_b32 = follow_c[:, cfg_model].astype(np.float32)   # (M, B)
    tpair_b32 = tpair_c[:, cfg_model].astype(np.float32)     # (M, B)
    zero_chunk = np.zeros((chunk, 1), np.float32)

    for start in range(0, len(a_idx), chunk):
        idx = a_idx[start:start + chunk]
        nvalid = len(idx)
        if nvalid < chunk:               # pad: keep one block shape
            idx = np.concatenate([idx, np.repeat(idx[-1:],
                                                 chunk - nvalid)])
        ma = cfg_model[idx]
        f3 = follow_b32[ma] if max_level >= 3 else zero_chunk
        tp = tpair_b32[ma] if max_level >= 3 else zero_chunk
        acc2, t2, acc3, t3 = _eval_chunk(
            c_d[put(idx, torch.int64)], put(st["cc_sum"][idx]),
            put(st["p_cert"][idx]), put(first32[ma]), put(follow32[ma]),
            put(f3), put(tp))
        acc2 = acc2.cpu().numpy()[:nvalid]
        t2 = t2.cpu().numpy()[:nvalid]
        idx = idx[:nvalid]
        red.push(acc2, t2, KIND_TWO,
                 np.repeat(idx, m_models),
                 np.tile(np.arange(m_models), nvalid))
        if max_level >= 3:
            acc3 = acc3.cpu().numpy()[:nvalid]
            t3 = t3.cpu().numpy()[:nvalid]
            red.push(acc3, t3, KIND_THREE,
                     np.repeat(idx, len(b_idx)),
                     np.tile(b_idx, nvalid))
    return red.result(n_t, trusted)


# ------------------------------------------------------- naive reference ---
def simulate_cascade(levels, scores_eval, truth):
    """Per-image reference simulator. levels: list of
    (model_idx, p_low|None, p_high|None); None thresholds = final level.
    Returns (accuracy, level_reach_fractions)."""
    s = np.asarray(scores_eval)
    y = np.asarray(truth, bool)
    n = s.shape[1]
    correct = 0
    reach = np.zeros(len(levels))
    for i in range(n):
        for li, (m, lo, hi) in enumerate(levels):
            reach[li] += 1
            o = s[m, i]
            final = lo is None
            if final or o <= lo or o >= hi:
                pred = o >= (0.5 if final else hi)
                correct += int(pred == y[i])
                break
    return correct / n, reach / n


def cascade_time_naive(levels, scores_eval, reps, infer_s, profile,
                       scenario, pyramid: bool = True):
    """Expected per-image cost by explicit per-image walk (reference).
    pyramid: follow-up representations are transformed from the smallest
    already-materialized pyramid level whose resolution they divide
    (matching evaluate_cascades and the executor's derivation policy)."""
    s = np.asarray(scores_eval)
    n = s.shape[1]
    total = 0.0
    for i in range(n):
        seen_reps = []
        mat_res = []                      # materialized pyramid levels
        for li, (m, lo, hi) in enumerate(levels):
            if reps[m] not in seen_reps:
                src = None
                if pyramid and mat_res:
                    usable = [r for r in mat_res
                              if r % reps[m].resolution == 0]
                    src = min(usable) if usable else None
                total += rep_cost_s(profile, reps[m], scenario,
                                    first_rep=not seen_reps,
                                    source_hw=src)
                seen_reps.append(reps[m])
                mat_res.append(reps[m].resolution)
            total += infer_s[m]
            o = s[m, i]
            if lo is None or o <= lo or o >= hi:
                break
    return total / n


def spec_levels(space: CascadeSpace, i: int, p_low, p_high):
    """Decode cascade i into [(model_idx, p_low|None, p_high|None)] per
    level (None thresholds = the final level)."""
    k, a, b = space.kind[i], space.i1[i], space.i2[i]
    nt = space.n_targets
    if k == KIND_SINGLE:
        return [(int(a), None, None)]
    if k == KIND_TWO:
        m1, t1 = divmod(int(a), nt)
        return [(m1, p_low[m1, t1], p_high[m1, t1]), (int(b), None, None)]
    m1, t1 = divmod(int(a), nt)
    m2, t2 = divmod(int(b), nt)
    return [(m1, p_low[m1, t1], p_high[m1, t1]),
            (m2, p_low[m2, t2], p_high[m2, t2]),
            (space.trusted, None, None)]
