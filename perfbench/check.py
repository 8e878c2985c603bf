"""The output check: what the timed path produced against the plain reference.

For each sampled frame, every instance's packed row (cloud count and extent,
rotation, translation, scale, loss, winning branch) is held against the
reference's row for the same frame, mask and draws, and every crop's ViT
token grid (and each single's descriptors) against the reference's.
`summarize` gives, over the sample:

  desc_rel       largest relative L2 difference of a crop's token grid (or of
                 a single's descriptors)
  off_instances  how many instances part from the reference: a rotation
                 difference over 0.3 degrees (for a category symmetric about
                 its up axis, of the up axes alone), a translation difference
                 over 1 mm, or a scale difference over a tenth
  off_route_share  the largest share of off instances on one route (the
                 singles, or the group programs of one bucket) among the
                 routes that hold three sampled instances or more
  the largest, upper-quartile and median differences, the off instances of
  each route (`off.single`, `off.group<bucket>`), the picks that differ, the
  clouds' count and extent, the losses: readings, not compared

A pose is the outcome of discrete choices (vote peaks, the branch arbiter's
pick) that a last-bit difference tips where two candidates tie to rounding:
about one instance in a hundred then moves by degrees and centimetres.
Every other instance agrees to a tenth of a degree and a millimetre. The
count passes the few ties a sample of twenty holds and fails a fault that
moves a fifth of it; the share fails a fault confined to one route, since
the sample holds three or more of each route a mix exercises on purpose
(`harness._sampled`).

The scale is the median of the visual branch's bfloat16 scale outputs over
its kept pairs: it moves by a bfloat16 step where the descriptors differ by
their rounding, as far as the control moves it, so it is held only against
gross faults (a tenth).

`limits/<cell>.json` names the numbers compared and gives each its limit; a
run is correct when every one lies at or under it and at least one instance
was compared.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

SYMMETRIC = ("bottle", "bowl", "can")
# an instance is off the reference past any of these
OFF_ROT_DEG, OFF_TRANS_MM, OFF_SCALE_REL = 0.3, 1.0, 0.1


def rotation_deg(rp: np.ndarray, rr: np.ndarray, symmetric: bool) -> float:
    if symmetric:
        c = float(np.dot(rp[:, 1], rr[:, 1]) / (np.linalg.norm(rp[:, 1]) * np.linalg.norm(rr[:, 1])))
    else:
        c = (float(np.trace(rp.T @ rr)) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))


def instance_gaps(prog: np.ndarray, ref: np.ndarray, cat: str) -> Dict[str, float]:
    """The differences of one instance's rows (22 values each)."""
    if not (np.all(np.isfinite(prog)) and np.all(np.isfinite(ref))):
        return {"count_gap": math.inf, "extent_mm": math.inf, "rot_deg": math.inf,
                "trans_mm": math.inf, "scale_rel": math.inf, "pick": math.inf, "loss_rel": math.inf}
    rp, rr = prog[4:13].reshape(3, 3), ref[4:13].reshape(3, 3)
    return {
        "count_gap": abs(float(prog[0] - ref[0])),
        "extent_mm": 1e3 * float(np.max(np.abs(prog[1:4] - ref[1:4]))),
        "rot_deg": rotation_deg(rp, rr, cat in SYMMETRIC),
        "trans_mm": 1e3 * float(np.linalg.norm(prog[13:16] - ref[13:16])),
        "scale_rel": float(np.linalg.norm(prog[16:19] - ref[16:19]) / max(np.linalg.norm(ref[16:19]), 1e-12)),
        "pick": float(prog[21] != ref[21]),
        "loss_rel": float(abs(prog[20] - ref[20]) / max(abs(ref[20]), 1e-12)),
    }


def rel_l2(prog, ref) -> float:
    """||prog - ref|| / ||ref|| of two tensors of one shape, in float64."""
    import torch

    p, r = prog.double(), ref.double()
    if not torch.all(torch.isfinite(p)):
        return math.inf
    return float(torch.linalg.vector_norm(p - r) / torch.clamp(torch.linalg.vector_norm(r), min=1e-30))


def is_off(g: Dict[str, float]) -> bool:
    return not (g["rot_deg"] <= OFF_ROT_DEG and g["trans_mm"] <= OFF_TRANS_MM
                and g["scale_rel"] <= OFF_SCALE_REL)


def summarize(gaps: Sequence[Dict[str, float]], desc: Sequence[float],
              routes: Sequence[str]) -> Dict[str, float]:
    """Over the sampled instances (each on the route named in `routes`) and
    crops: the off instances, in all and by route; each difference's largest
    value, upper quartile and median; the branch picks that differ; the
    descriptors' largest and median relative difference."""
    off = [is_off(g) for g in gaps]
    out = {"off_instances": float(sum(off)), "off_route_share": 0.0}
    for r in sorted(set(routes)):
        n = sum(q == r for q in routes)
        out[f"off.{r}"] = float(sum(o for o, q in zip(off, routes) if q == r))
        out[f"instances.{r}"] = float(n)
        if n >= 3:
            out["off_route_share"] = max(out["off_route_share"], out[f"off.{r}"] / n)
    for k in ("count_gap", "extent_mm", "rot_deg", "trans_mm", "scale_rel", "loss_rel"):
        vals = [g[k] for g in gaps]
        out[k] = max(vals) if vals else math.nan
        out[k + "_p75"] = float(np.percentile(vals, 75)) if vals else math.nan
        out[k + "_median"] = float(np.median(vals)) if vals else math.nan
    out["pick_flips"] = float(sum(g["pick"] != 0 for g in gaps))
    out["desc_rel"] = max(desc) if desc else math.nan
    out["desc_rel_median"] = float(np.median(desc)) if desc else math.nan
    out["instances"] = float(len(gaps))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> (bool, Dict[str, Dict]):
    """(correct, {name: {value, limit}}) over the numbers `limits` names."""
    checked = {k: {"value": numbers.get(k, math.nan), "limit": v} for k, v in limits.items()}
    ok = numbers.get("instances", 0) > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())
    return ok, checked


def lines(checked: Dict[str, Dict]) -> List[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checked.items()]
