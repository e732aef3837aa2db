"""Deployment-scenario-aware data handling costs (paper §III issue 4, §VI).

t_classify = t_load + t_transform + t_infer, with the representation costs
charged ONCE per distinct representation per image (§VII-A3). Scenarios:

  INFER_ONLY - inference only (the computer-vision-literature convention)
  ARCHIVE    - load the full-size image from SSD once + transform into each
               distinct representation the cascade needs
  ONGOING    - representations were materialized at ingest; pay only the
               (smaller) per-representation load
  CAMERA     - frames arrive in memory from the sensor; pay transforms only

The CostProfile holds *measured* per-model inference seconds (profiled on
the device the bank runs on) and *modeled* per-representation data
handling seconds. All times are seconds/image. A numpy copy of the
reference module.

Pyramid pricing (DESIGN.md §3): a follow-up level whose resolution divides
an already-materialized level's resolution is produced from that level, not
from the raw base image — ``transform_from_s`` prices that *incremental*
t_transform. Profiles built by hand (without the modeled bandwidth fields)
degrade gracefully to the seed's from-base pricing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from repro_torch.core.transforms import Representation

SCENARIOS = ("INFER_ONLY", "ARCHIVE", "ONGOING", "CAMERA")

# ``DecomposedCost.rep_s`` key for the ARCHIVE scenario's full-size raw
# image load. It is not a pyramid level, but it shares exactly like one:
# a multi-predicate scan loads each raw image ONCE no matter how many
# cascades read representations derived from it. 0 can never collide
# with a real resolution.
FULL_LOAD = 0

# Deployment-environment constants used when costs are modeled instead of
# measured. Per-image fixed overheads reflect file open + JPEG decode for
# full images and packed-binary reads for pre-materialized representations
# (the reference's modeled deployment constants, kept identical so both
# packages price cascades the same way).
SSD_BW = 2.0e9
CAMERA_DMA_BW = 8.0e9
TRANSFORM_BW = 4.0e9             # host-side resize throughput
LOAD_FULL_OVERHEAD_S = 1.5e-3    # open + decode a full-size image
LOAD_REP_OVERHEAD_S = 30e-6      # read a pre-sized packed representation
TRANSFORM_OVERHEAD_S = 20e-6     # per-op dispatch/copy


@dataclass
class CostProfile:
    """Per-deployment measured/modeled costs.
    infer_s[model_id]        : seconds/image of pure inference
    transform_s[rep.name]    : seconds/image to produce rep from raw
    load_rep_s[rep.name]     : seconds/image to load rep from storage
    load_full_s              : seconds/image to load the full-size raw image

    The optional pyramid fields enable incremental t_transform pricing
    (``transform_from_s``); ``modeled`` fills them in, hand-built profiles
    may leave them None and keep the seed's from-base pricing.
    """
    infer_s: Mapping[str, float]
    transform_s: Mapping[str, float]
    load_rep_s: Mapping[str, float]
    load_full_s: float
    transform_bw: float | None = None        # bytes/s of the resize path
    transform_overhead_s: float = TRANSFORM_OVERHEAD_S
    byte_scale: float = 1.0                  # corpus -> paper-regime bytes
    base_hw: int | None = None

    @staticmethod
    def modeled(model_infer_s: Mapping[str, float],
                reps: list[Representation], base_hw: int,
                scale: float = 1.0) -> "CostProfile":
        """scale: byte-scale multiplier mapping reduced-resolution stand-in
        corpora onto the paper's 224px regime (scale = (224/base_hw)^2)."""
        full_bytes = base_hw * base_hw * 3 * scale
        return CostProfile(
            infer_s=dict(model_infer_s),
            transform_s={r.name: TRANSFORM_OVERHEAD_S
                         + (full_bytes + r.bytes * scale) / TRANSFORM_BW
                         for r in reps},
            load_rep_s={r.name: LOAD_REP_OVERHEAD_S
                        + r.bytes * scale / SSD_BW for r in reps},
            load_full_s=LOAD_FULL_OVERHEAD_S + full_bytes / SSD_BW,
            transform_bw=TRANSFORM_BW,
            transform_overhead_s=TRANSFORM_OVERHEAD_S,
            byte_scale=scale,
            base_hw=base_hw,
        )

    def transform_from_s(self, rep: Representation,
                         source_hw: int | None) -> float:
        """Incremental t_transform: produce ``rep`` from an already
        materialized RGB pyramid level at ``source_hw``. Falls back to the
        from-base price when the profile lacks bandwidth fields, when no
        source is given, or when the source cannot serve this resolution."""
        if (self.transform_bw is None or source_hw is None
                or source_hw % rep.resolution != 0
                or (self.base_hw is not None and source_hw >= self.base_hw)):
            return self.transform_s[rep.name]
        read = source_hw * source_hw * 3 * self.byte_scale
        return self.transform_overhead_s \
            + (read + rep.bytes * self.byte_scale) / self.transform_bw


def rep_cost_s(profile: CostProfile, rep: Representation,
               scenario: str, first_rep: bool,
               source_hw: int | None = None) -> float:
    """Data-handling cost of materializing ``rep`` for one image under
    ``scenario``. first_rep: True when this is the first representation the
    cascade touches (ARCHIVE pays the full-size load exactly once).
    source_hw: resolution of the nearest already-materialized RGB pyramid
    level, when the executor can derive ``rep`` from it (DESIGN.md §3)."""
    if scenario == "INFER_ONLY":
        return 0.0
    if scenario == "ARCHIVE":
        return (profile.load_full_s if first_rep else 0.0) \
            + profile.transform_from_s(rep, source_hw)
    if scenario == "ONGOING":
        return profile.load_rep_s[rep.name]
    if scenario == "CAMERA":
        return profile.transform_from_s(rep, source_hw)
    raise ValueError(scenario)


# ---------------------------------------------- decomposed §VI pricing -----
@dataclass
class DecomposedCost:
    """One cascade's expected §VI seconds/image, split into the two
    physically different spends (DESIGN.md §11):

    ``infer_s``  — expected pure-inference seconds/image (every level's
                   infer_s weighted by its reach probability);
    ``rep_s``    — expected representation-HANDLING seconds/image, keyed
                   by the pyramid level (RGB resolution) each charge
                   materializes, plus ``FULL_LOAD`` for ARCHIVE's raw
                   load. These are the charges a multi-predicate scan can
                   SHARE: the engine materializes one pyramid per chunk
                   covering the union of every cascade's levels, so a
                   level an earlier predicate already pays for is free to
                   later predicates.

    ``total_s`` reproduces the standalone §VI expected cost exactly
    (``== CascadeSpace.time_s[i]``, tests/test_joint_planner.py);
    ``marginal_s`` is the same cascade priced when ``materialized``
    levels already exist — the joint planner's unit of cost."""
    infer_s: float
    rep_s: dict = field(default_factory=dict)   # {resolution|FULL_LOAD: s}

    @property
    def levels(self) -> frozenset:
        """Every rep_s key this cascade touches (pyramid resolutions,
        plus FULL_LOAD under ARCHIVE)."""
        return frozenset(self.rep_s)

    @property
    def rep_total_s(self) -> float:
        return float(sum(self.rep_s.values()))

    @property
    def total_s(self) -> float:
        """Standalone expected seconds/image (the §VI cost the cascade
        evaluator prices and the independent planner ranks by)."""
        return self.infer_s + self.rep_total_s

    def marginal_rep_s(self, materialized) -> float:
        """Rep-handling cost excluding levels in ``materialized`` (levels
        an earlier predicate in the plan order already pays for). Never
        exceeds ``rep_total_s`` — the basis of the joint planner's
        never-worse-than-independent guarantee."""
        return float(sum(s for r, s in self.rep_s.items()
                         if r not in materialized))

    def marginal_s(self, materialized) -> float:
        return self.infer_s + self.marginal_rep_s(materialized)

    def scaled(self, eval_frac: float) -> "DecomposedCost":
        """This cascade priced when only ``eval_frac`` of the candidate
        rows still need evaluation — the rest are answered from a
        seeded virtual column (engine/ingest.CandidateIndex decided
        labels, DESIGN.md §14/§15). Every charge scales linearly and
        the level set is preserved, so shared-pyramid marginal pricing
        (``marginal_s``) composes with index-aware planning."""
        f = float(eval_frac)
        return DecomposedCost(self.infer_s * f,
                              {r: s * f for r, s in self.rep_s.items()})


def decompose_cascade_cost(levels, scores_eval, reps, infer_s,
                           profile: CostProfile, scenario: str,
                           pyramid: bool = True,
                           dense_levels: bool = False) -> DecomposedCost:
    """Decompose one cascade's expected cost over the eval split.

    ``levels``: [(model_idx, p_low|None, p_high|None)] (the
    cascade.spec_levels format); ``scores_eval``: (M, I) cached scores;
    ``reps``: per-model Representation. The walk is the vectorized twin
    of the reference's per-image ``cascade_time_naive`` — every charge a
    level incurs is identical for all images reaching it, so summing
    per-level charges
    weighted by reach fractions reproduces the per-image walk exactly —
    but each rep-handling charge is attributed to the pyramid level
    (resolution) it materializes instead of being folded into one
    scalar. ARCHIVE's full-size raw load is split out under the
    ``FULL_LOAD`` key (it too is shared across predicates).

    ``dense_levels=True`` prices the ENGINE's execution instead of the
    paper's per-image walk: every level is charged at reach probability
    1. The scan paths deliberately run full-width levels (static
    shapes, batch-packing-independent labels — engine/scan.py
    CompiledCascade), so a flushed batch pays EVERY level of the
    cascade for every row; reach-weighted §VI costing systematically
    undercharges multi-level cascades there. The joint planner uses
    this mode by default (engine/planner.plan_query costing='engine')
    because the plan it emits is executed by exactly those paths.
    NOTE: this is WITHIN-cascade pricing (a flushed batch runs every
    level of its own cascade full-width); it is orthogonal to the
    CROSS-predicate rep-charge weighting (joint_scan_cost dense_reps),
    where the engines' lazy first-touch schedule means a later
    predicate's levels are only pooled for rows surviving to it."""
    import numpy as np

    s = np.asarray(scores_eval)
    n = s.shape[1]
    active = np.ones(n, bool)
    seen: list = []                     # Representations already priced
    mat: list[int] = []                 # materialized pyramid resolutions
    rep_charges: dict = {}
    infer_total = 0.0
    for m, lo, hi in levels:
        p = (1.0 if dense_levels
             else float(active.sum()) / n)   # P(reach this level)
        if p == 0.0:
            break
        rep = reps[m]
        if rep not in seen:
            src = None
            if pyramid and mat:
                usable = [r for r in mat if r % rep.resolution == 0]
                src = min(usable) if usable else None
            c = rep_cost_s(profile, rep, scenario, first_rep=not seen,
                           source_hw=src)
            if scenario == "ARCHIVE" and not seen:
                rep_charges[FULL_LOAD] = (rep_charges.get(FULL_LOAD, 0.0)
                                          + p * profile.load_full_s)
                c -= profile.load_full_s
            rep_charges[rep.resolution] = (
                rep_charges.get(rep.resolution, 0.0) + p * c)
            seen.append(rep)
            mat.append(rep.resolution)
        infer_total += p * float(infer_s[m])
        if lo is None:
            break
        o = s[m]
        active = active & ~((o <= lo) | (o >= hi))
    return DecomposedCost(infer_total, rep_charges)
