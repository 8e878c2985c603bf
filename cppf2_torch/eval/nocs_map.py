"""NOCS-protocol mAP: 3D IoU AP curves + (degree, cm) pose AP grids.

The port's own copy of `cppf2_tpu/eval/nocs_map.py` (numpy only), a
re-implementation of the reference's evaluation stack
(utils/util.py:1665-1754 compute_3d_matches, :1757-1782 VOC AP,
:1785-1808/:1884-1928 RT overlaps + matching, :2610-2733 per-image worker,
:2736-2955 compute_degree_cm_mAP) with the same protocol:

  * predictions sorted by score; greedy one-to-one matching per threshold;
  * rotation part of every RT normalized by det^(1/3), the scale folded into
    `scales` (work, utils/util.py:2619-2634);
  * pose AP optionally gated on the IoU@`iou_pose_thres` matches
    (`use_matches_for_pose`, utils/util.py:2690-2708);
  * degree/shift threshold lists augmented with (360, 100) sentinels;
  * per-class APs and the mean over real classes.

Runs per-image workers through an optional process pool (the reference uses
Pool(10), utils/util.py:2774); the default is inline. matplotlib is imported
only for `plot=True`.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from cppf2_torch.eval.iou3d import pairwise_iou_matrix
from cppf2_torch.eval.pose_errors import pose_error_degree_cm


def _match_greedy(overlaps: np.ndarray, pred_cls: np.ndarray, gt_cls: np.ndarray,
                  thresholds: Sequence[float], larger_is_better: bool = True):
    """Greedy one-to-one matching per threshold. overlaps: (num_pred, num_gt)."""
    num_t = len(thresholds)
    num_pred, num_gt = overlaps.shape
    pred_matches = -np.ones((num_t, num_pred))
    gt_matches = -np.ones((num_t, num_gt))
    # the per-prediction gt ordering is threshold-invariant: sort once, not
    # once per (threshold, pred) — 101 IoU thresholds would redo it 101x
    orders = [
        np.argsort(overlaps[i])[::-1] if larger_is_better
        else np.argsort(overlaps[i])
        for i in range(num_pred)
    ]
    for s, thr in enumerate(thresholds):
        for i in range(num_pred):
            order = orders[i]
            for j in order:
                if gt_matches[s, j] > -1:
                    continue
                v = overlaps[i, j]
                if larger_is_better and v < thr:
                    break
                if pred_cls[i] != gt_cls[j]:
                    continue
                # at v == thr exactly the reference neither matches nor stops
                # (util.py:1743-1751: `< thr` breaks, only `> thr` matches)
                if larger_is_better and v <= thr:
                    continue
                gt_matches[s, j] = i
                pred_matches[s, i] = j
                break
    return gt_matches, pred_matches


def _match_pose(overlaps: np.ndarray, pred_cls, gt_cls, degree_list, shift_list):
    """(degree, shift) matching grid (utils/util.py:1884-1928)."""
    nd, ns = len(degree_list), len(shift_list)
    num_pred, num_gt = overlaps.shape[:2]
    pred_matches = -np.ones((nd, ns, num_pred))
    gt_matches = -np.ones((nd, ns, num_gt))
    if num_pred == 0 or num_gt == 0:
        return gt_matches, pred_matches
    # threshold-invariant per-prediction ordering, hoisted out of the
    # (degree, shift) grid (the reference re-sorts per cell, util.py:1907)
    orders = [np.argsort(np.sum(overlaps[i], axis=-1))
              for i in range(num_pred)]
    for d, dt in enumerate(degree_list):
        for s, st in enumerate(shift_list):
            for i in range(num_pred):
                order = orders[i]
                for j in order:
                    if gt_matches[d, s, j] > -1 or pred_cls[i] != gt_cls[j]:
                        continue
                    if overlaps[i, j, 0] > dt or overlaps[i, j, 1] > st:
                        continue
                    gt_matches[d, s, j] = i
                    pred_matches[d, s, i] = j
                    break
    return gt_matches, pred_matches


def _voc_ap(pred_match: np.ndarray, pred_scores: np.ndarray, gt_match: np.ndarray) -> float:
    """VOC-style AP from score-sorted match vectors (utils/util.py:1757-1782)."""
    if len(gt_match) == 0:
        return 0.0 if len(pred_match) else np.nan
    order = np.argsort(pred_scores)[::-1]
    pred_match = pred_match[order]
    tp_cum = np.cumsum(pred_match > -1)
    precisions = tp_cum / (np.arange(len(pred_match)) + 1)
    recalls = tp_cum.astype(np.float64) / len(gt_match)
    precisions = np.concatenate([[0], precisions, [0]])
    recalls = np.concatenate([[0], recalls, [1]])
    for i in range(len(precisions) - 2, -1, -1):
        precisions[i] = max(precisions[i], precisions[i + 1])
    idx = np.where(recalls[:-1] != recalls[1:])[0] + 1
    return float(np.sum((recalls[idx] - recalls[idx - 1]) * precisions[idx]))


def _work_image(args):
    """Per-image match computation (utils/util.py:2610-2733)."""
    (res, synset_names, iou_thres_list, degree_list, shift_list,
     use_matches_for_pose, iou_pose_thres) = args
    num_classes = len(synset_names)

    gt_cls = np.asarray(res.get("gt_class_ids", []), np.int32)
    gt_rts = np.asarray(res.get("gt_RTs", np.zeros((0, 4, 4))), np.float64)
    gt_scales = np.asarray(res.get("gt_scales", np.zeros((0, 3))), np.float64)
    gt_vis = np.asarray(
        res.get("gt_handle_visibility", np.ones_like(gt_cls)), np.int32
    )
    if len(gt_rts):
        norms = np.cbrt(np.linalg.det(gt_rts[:, :3, :3]))
        gt_rts = gt_rts.copy()
        gt_rts[:, :3, :3] /= norms[:, None, None] + 1e-7
        gt_scales = gt_scales * norms[:, None]

    pred_cls = np.asarray(res.get("pred_class_ids", []), np.int32)
    pred_rts = np.asarray(res.get("pred_RTs", np.zeros((0, 4, 4))), np.float64)
    pred_scales = np.asarray(res.get("pred_scales", np.zeros((0, 3))), np.float64)
    pred_scores = np.asarray(res.get("pred_scores", np.ones(len(pred_cls))), np.float64)
    if len(pred_rts):
        norms = np.cbrt(np.linalg.det(pred_rts[:, :3, :3]))
        pred_rts = pred_rts.copy()
        pred_rts[:, :3, :3] /= norms[:, None, None] + 1e-7
        pred_scales = pred_scales * norms[:, None]

    out = {}
    for cls_id in range(1, num_classes):
        g_sel = gt_cls == cls_id
        p_sel = pred_cls == cls_id
        c_gt_rts, c_gt_scales, c_gt_vis = gt_rts[g_sel], gt_scales[g_sel], gt_vis[g_sel]
        c_pred_rts, c_pred_scales = pred_rts[p_sel], pred_scales[p_sel]
        c_scores = pred_scores[p_sel]
        if synset_names[cls_id] != "mug":
            c_gt_vis = np.ones(len(c_gt_rts), np.int32)

        order = np.argsort(c_scores)[::-1]
        c_pred_rts, c_pred_scales, c_scores = (
            c_pred_rts[order], c_pred_scales[order], c_scores[order],
        )

        np_, ng = len(c_pred_rts), len(c_gt_rts)
        ious = pairwise_iou_matrix(
            c_pred_rts, c_pred_scales, c_gt_rts, c_gt_scales, c_gt_vis,
            synset_names[cls_id],
        )
        iou_gt_m, iou_pred_m = _match_greedy(
            ious, np.full(np_, cls_id), np.full(ng, cls_id), iou_thres_list
        )

        # pose stage, optionally gated on the IoU@iou_pose_thres matches
        pr, pg = c_pred_rts, c_gt_rts
        pvis = c_gt_vis
        pscores = c_scores
        if use_matches_for_pose:
            ti = list(iou_thres_list).index(iou_pose_thres)
            keep_p = iou_pred_m[ti] > -1
            keep_g = iou_gt_m[ti] > -1
            pr, pscores = pr[keep_p], pscores[keep_p]
            pg, pvis = pg[keep_g], pvis[keep_g]

        rt_over = np.zeros((len(pr), len(pg), 2))
        for i in range(len(pr)):
            for j in range(len(pg)):
                rt_over[i, j] = pose_error_degree_cm(
                    pr[i], pg[j], synset_names[cls_id], pvis[j]
                )
        pose_gt_m, pose_pred_m = _match_pose(
            rt_over, np.full(len(pr), cls_id), np.full(len(pg), cls_id),
            degree_list, shift_list,
        )
        out[cls_id] = (
            iou_pred_m, np.tile(c_scores, (len(iou_thres_list), 1)), iou_gt_m,
            pose_pred_m,
            np.tile(pscores, (len(degree_list), len(shift_list), 1)),
            pose_gt_m,
        )
    return out


def compute_degree_cm_map(
    final_results: List[Dict],
    synset_names: Sequence[str],
    log_dir: Optional[str] = None,
    degree_thresholds=(5, 10, 15),
    shift_thresholds=(5, 10, 15),
    iou_3d_thresholds=tuple(np.linspace(0, 1, 101)),
    iou_pose_thres: float = 0.1,
    use_matches_for_pose: bool = True,
    num_proc: int = 1,
    plot: bool = False,
    verbose: bool = True,
):
    """Aggregate per-image matches into AP tables (utils/util.py:2736-2955).

    Returns (iou_aps (C+1, T_iou), pose_aps (C+1, T_deg, T_shift)); index -1
    is the mean over real classes; degree/shift lists carry the reference's
    (360, 100) sentinel entries at the end.
    """
    num_classes = len(synset_names)
    degree_list = list(degree_thresholds) + [360]
    shift_list = list(shift_thresholds) + [100]
    iou_list = list(iou_3d_thresholds)
    if use_matches_for_pose:
        assert iou_pose_thres in iou_list

    args = [
        (res, synset_names, iou_list, degree_list, shift_list,
         use_matches_for_pose, iou_pose_thres)
        for res in final_results
    ]
    if num_proc > 1:
        # spawn, not fork: a forked child of a process that has initialized
        # CUDA or torch's thread pools can deadlock (the workers are pure
        # numpy, so a fresh interpreter per worker is also the cheap option)
        from multiprocessing import get_context

        with get_context("spawn").Pool(num_proc) as pool:
            results = pool.map(_work_image, args)
    else:
        results = [_work_image(a) for a in args]

    acc = {
        cls_id: {"ipm": [], "ips": [], "igm": [], "ppm": [], "pps": [], "pgm": []}
        for cls_id in range(1, num_classes)
    }
    for r in results:
        for cls_id, (ipm, ips, igm, ppm, pps, pgm) in r.items():
            a = acc[cls_id]
            a["ipm"].append(ipm)
            a["ips"].append(ips)
            a["igm"].append(igm)
            a["ppm"].append(ppm)
            a["pps"].append(pps)
            a["pgm"].append(pgm)

    iou_aps = np.zeros((num_classes + 1, len(iou_list)))
    pose_aps = np.zeros((num_classes + 1, len(degree_list), len(shift_list)))
    for cls_id in range(1, num_classes):
        a = acc[cls_id]
        ipm = np.concatenate(a["ipm"], -1)
        ips = np.concatenate(a["ips"], -1)
        igm = np.concatenate(a["igm"], -1)
        ppm = np.concatenate(a["ppm"], -1)
        pps = np.concatenate(a["pps"], -1)
        pgm = np.concatenate(a["pgm"], -1)
        for s in range(len(iou_list)):
            iou_aps[cls_id, s] = _voc_ap(ipm[s], ips[s], igm[s])
        for d in range(len(degree_list)):
            for s in range(len(shift_list)):
                pose_aps[cls_id, d, s] = _voc_ap(ppm[d, s], pps[d, s], pgm[d, s])
    # nanmean: a class absent from the evaluated subset (zero gts AND zero
    # preds, e.g. under --limit) scores NaN per _voc_ap — it must drop out
    # of the mean rather than wipe every headline mean to NaN. An all-NaN
    # column additionally raises "Mean of empty slice" through the warnings
    # module (errstate only covers the FP flags), so silence that too.
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Mean of empty slice")
        iou_aps[-1] = np.nanmean(iou_aps[1:-1], axis=0)
        pose_aps[-1] = np.nanmean(pose_aps[1:-1], axis=0)

    if verbose:
        names = list(synset_names)
        for idx_thr, label in ((iou_list.index(0.25) if 0.25 in iou_list else None, "25"),
                               (iou_list.index(0.5) if 0.5 in iou_list else None, "50")):
            if idx_thr is not None:
                for cls_id in range(1, num_classes):
                    print(f"{names[cls_id]} 3D IoU at {label}: {iou_aps[cls_id, idx_thr] * 100:.1f}")
                print(f"3D IoU at {label}: {iou_aps[-1, idx_thr] * 100:.1f}")
        for d, dt in enumerate(degree_list[:-1]):
            for s, st in enumerate(shift_list[:-1]):
                print(f"{dt} degree, {st}cm: {pose_aps[-1, d, s] * 100:.1f}")

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        np.savez(
            os.path.join(log_dir, "aps.npz"),
            iou_aps=iou_aps, pose_aps=pose_aps,
            iou_thresholds=np.asarray(iou_list),
            degree_thresholds=np.asarray(degree_list),
            shift_thresholds=np.asarray(shift_list),
        )
        if plot:
            _plot_curves(log_dir, synset_names, iou_aps, pose_aps, iou_list,
                         degree_list, shift_list, use_matches_for_pose)
    return iou_aps, pose_aps


def _plot_curves(
    log_dir, synset_names, iou_aps, pose_aps, iou_list, degree_list, shift_list,
    use_matches_for_pose: bool = True,
):
    """Full reference artifact set (utils/util.py:2797-2930): IoU AP curve +
    pkl, per-class and mean pose-AP heatmaps over (degree, cm), AP-vs-cm and
    AP-vs-degree curves, and the pose AP pkl."""
    import pickle

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    num_classes = len(synset_names)
    prefix = "Pose_Only_" if use_matches_for_pose else "Pose_Detection_"
    d_lo, d_hi = degree_list[0], degree_list[-2]
    s_lo, s_hi = shift_list[0], shift_list[-2]

    def _line_plot(path, xlabel, xs, series, ylim=(0, 1.05)):
        fig = plt.figure()
        ax = plt.subplot(111)
        plt.ylabel("AP")
        plt.ylim(ylim)
        plt.xlabel(xlabel)
        for label, ys in series:
            ax.plot(xs, ys, label=label)
        ax.legend()
        fig.savefig(os.path.join(log_dir, path))
        plt.close(fig)

    # IoU AP curve + pkl (utils/util.py:2797-2826)
    iou_name = f"IoU_3D_AP_{iou_list[0]}-{iou_list[-1]}"
    _line_plot(
        iou_name + ".png", "3D IoU thresholds", iou_list,
        [(synset_names[c], iou_aps[c]) for c in range(1, num_classes)]
        + [("mean", iou_aps[-1])],
        ylim=(0, 1),
    )
    with open(os.path.join(log_dir, iou_name + ".pkl"), "wb") as f:
        pickle.dump({"thres_list": list(iou_list), "aps": iou_aps}, f)

    # pose AP pkl (utils/util.py:2836-2862)
    pose_name = f"AP_{d_lo}-{d_hi}degree_{s_lo}-{s_hi}cm"
    with open(os.path.join(log_dir, prefix + pose_name + ".pkl"), "wb") as f:
        pickle.dump(
            {
                "degree_thres": list(degree_list),
                "shift_thres_list": list(shift_list),
                "aps": pose_aps,
            },
            f,
        )

    # per-class + mean pose-AP heatmaps over (degree, cm) (utils/util.py:2860-2895)
    def _heatmap(path, grid):
        fig = plt.figure()
        plt.subplot(111)
        plt.ylabel("Rotation thresholds/degree")
        plt.xlabel("translation/cm")
        plt.imshow(
            grid[::-1], cmap="jet", interpolation="bilinear",
            extent=[s_lo, s_hi, d_lo, d_hi], aspect="auto",
        )
        plt.colorbar()
        plt.savefig(os.path.join(log_dir, path))
        plt.close(fig)

    for c in range(1, num_classes):
        _heatmap(
            f"{prefix}AP_{synset_names[c]}_{d_lo}-{d_hi}degree_{s_lo}-{s_hi}cm.png",
            pose_aps[c, :-1, :-1],
        )
    _heatmap(f"{prefix}m{pose_name}.png", pose_aps[-1, :-1, :-1])

    # AP vs cm (at the 360-degree sentinel row) and AP vs degree (at the
    # 100-cm sentinel column) (utils/util.py:2897-2930)
    _line_plot(
        f"{prefix}mAP_{s_lo}-{s_hi}cm.png", "translation/cm", shift_list[:-1],
        [(synset_names[c], pose_aps[c, -1, :-1]) for c in range(1, num_classes)]
        + [("mean", pose_aps[-1, -1, :-1])],
    )
    _line_plot(
        f"{prefix}mAP_{d_lo}-{d_hi}degree.png", "Rotation/degree", degree_list[:-1],
        [(synset_names[c], pose_aps[c, :-1, -1]) for c in range(1, num_classes)]
        + [("mean", pose_aps[-1, :-1, -1])],
    )
