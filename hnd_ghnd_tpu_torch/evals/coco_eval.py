"""COCO-style evaluation (bbox / segm / keypoints) without pycocotools.

Counterpart of hnd_ghnd_tpu/evals/coco_eval.py, which replaces the
reference's evaluator stack (src/utils/coco_eval_util.py: CocoEvaluator +
patched pycocotools COCOeval) with the published COCOeval semantics:

  * IoU thresholds 0.50:0.05:0.95, 101-point interpolated precision,
    areas all/small/medium/large, maxDets (1, 10, 100);
  * greedy per-image matching in descending score order, each detection to
    the best still-unmatched GT (ties keep earlier GT), crowd GTs matchable
    many times with intersection-over-det-area IoU;
  * ignore semantics: GTs outside the area range are ignored, detections
    matched to ignored GTs are ignored, unmatched detections outside the
    area range are ignored in accumulate;
  * keypoints use OKS with the standard 17 sigmas and maxDets (20,).

The matching and the mask IoUs run in the native cocomask library where it
builds (evals/mask_rle.py; ``coco_match`` as JAX's coco_eval.py:129-150
dispatches it), else in numpy.  The host-side mask/keypoint
postprocessing lives in evals/postprocess.py; this module consumes final
predictions.  In a multi-process run each rank evaluates its shard and
``CocoEvaluator.synchronize_between_processes`` merges them.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hnd_ghnd_tpu_torch.data.coco import CocoDataset, ann_to_mask
from hnd_ghnd_tpu_torch.evals import mask_rle
from hnd_ghnd_tpu_torch.parallel import multihost

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
KP_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


def bbox_iou_matrix(dets: np.ndarray, gts: np.ndarray,
                    iscrowd: np.ndarray) -> np.ndarray:
    """IoU of det xywh vs gt xywh; crowd gt -> intersection / det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    da = (dets[:, 2] * dets[:, 3])[:, None]
    ga = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    out = np.zeros_like(inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def oks_matrix(det_kps: np.ndarray, gts: List[dict]) -> np.ndarray:
    """Object Keypoint Similarity, pycocotools computeOks semantics —
    vectorized as one broadcast [D, G, 17] computation (the published
    implementation is a per-(det, gt) Python loop; every elementwise op and
    its order is preserved, the final visible-keypoint sum may differ by
    ~1 ulp from the loop's due to numpy's pairwise-summation grouping)."""
    if len(det_kps) == 0 or len(gts) == 0:
        return np.zeros((len(det_kps), len(gts)))
    vars_ = (KP_SIGMAS * 2) ** 2                                   # [17]
    d = np.asarray(det_kps, dtype=np.float64)                      # [D,17,3]
    xd, yd = d[..., 0][:, None, :], d[..., 1][:, None, :]          # [D,1,17]
    g = np.asarray([np.asarray(gt["keypoints"], dtype=np.float64).reshape(-1, 3)
                    for gt in gts])                                # [G,17,3]
    xg, yg, vg = g[..., 0][None], g[..., 1][None], g[..., 2]       # [1,G,17]
    k1 = (vg > 0).sum(axis=1)                                      # [G]
    bb = np.asarray([gt["bbox"] for gt in gts], dtype=np.float64)  # [G,4]
    x0 = (bb[:, 0] - bb[:, 2])[None, :, None]
    x1 = (bb[:, 0] + 2 * bb[:, 2])[None, :, None]
    y0 = (bb[:, 1] - bb[:, 3])[None, :, None]
    y1 = (bb[:, 1] + 2 * bb[:, 3])[None, :, None]
    areas = np.asarray([gt["area"] for gt in gts],
                       dtype=np.float64)[None, :, None]            # [1,G,1]
    vis = (k1 > 0)[None, :, None]                                  # [1,G,1]
    # visible-gt branch: plain keypoint offsets; no-visible branch:
    # distance outside the 3x-expanded gt box
    dx = np.where(vis, xd - xg,
                  np.maximum(0.0, x0 - xd) + np.maximum(0.0, xd - x1))
    dy = np.where(vis, yd - yg,
                  np.maximum(0.0, y0 - yd) + np.maximum(0.0, yd - y1))
    e = (dx ** 2 + dy ** 2) / vars_ / (areas + np.spacing(1)) / 2  # [D,G,17]
    exp_e = np.exp(-e)
    vmask = (vg > 0)[None]                                         # [1,G,17]
    # k1>0: mean over visible keypoints (adding exact 0.0 terms preserves
    # the fp sum bit-for-bit); k1==0: mean over all 17
    num = np.where(np.broadcast_to(vis, e.shape),
                   np.where(np.broadcast_to(vmask, e.shape), exp_e, 0.0),
                   exp_e).sum(axis=-1)
    den = np.where(k1 > 0, k1, e.shape[-1])[None]
    return num / den


def match_greedy(ious_s: np.ndarray, g_ignore: np.ndarray,
                 thrs: np.ndarray) -> np.ndarray:
    """Greedy COCOeval matching over [D, G] IoUs (gts sorted
    non-ignored-first).  Returns [T, D] matched-gt index (-1 = unmatched).

    The published loop (src/utils/coco_eval_util.py:295-340): later gt
    wins IoU ties; ignored gts are rematchable, reachable only when no
    non-ignored gt qualifies.  The native ``coco_match`` runs it where the
    cocomask library is built, ``match_greedy_np`` otherwise."""
    lib = mask_rle.get_lib()
    if lib is None:
        return match_greedy_np(ious_s, g_ignore, thrs)
    n_d, n_g = ious_s.shape
    ious_c = np.ascontiguousarray(ious_s, dtype=np.float64)
    gig_c = np.ascontiguousarray(g_ignore, dtype=np.uint8)
    thrs_c = np.ascontiguousarray(thrs, dtype=np.float64)
    out = np.empty((len(thrs), n_d), dtype=np.int32)
    lib.coco_match(mask_rle._ptr(ious_c, mask_rle._F64P), n_d, n_g,
                   mask_rle._ptr(gig_c, mask_rle._U8P),
                   mask_rle._ptr(thrs_c, mask_rle._F64P), len(thrs),
                   mask_rle._ptr(out, mask_rle._I32P))
    return out


def match_greedy_np(ious_s: np.ndarray, g_ignore: np.ndarray,
                    thrs: np.ndarray) -> np.ndarray:
    n_d, n_g = ious_s.shape
    n_t = len(thrs)
    out = np.full((n_t, n_d), -1, dtype=np.int32)
    gig = g_ignore.astype(bool)
    for t_i, thr in enumerate(thrs):
        gtm = np.zeros(n_g, dtype=bool)
        for d_i in range(n_d):
            best = min(thr, 1 - 1e-10)
            m = -1
            for g_i in range(n_g):
                if gtm[g_i] and not gig[g_i]:
                    continue
                if m > -1 and not gig[m] and gig[g_i]:
                    break
                if ious_s[d_i, g_i] < best:
                    continue
                best = ious_s[d_i, g_i]
                m = g_i
            if m > -1:
                out[t_i, d_i] = m
                gtm[m] = True
    return out


class COCOEvalNP:
    """Pure-numpy COCOeval: evaluate -> accumulate -> summarize."""

    def __init__(self, iou_type: str = "bbox"):
        assert iou_type in ("bbox", "segm", "keypoints")
        self.iou_type = iou_type
        self.max_dets = (20,) if iou_type == "keypoints" else (1, 10, 100)
        if iou_type == "keypoints":
            self.area_labels = ("all", "medium", "large")
        else:
            self.area_labels = ("all", "small", "medium", "large")
        # per (image, category): detections and ground truths
        self.gts: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        self.dts: Dict[Tuple[int, int], List[dict]] = defaultdict(list)
        self.img_ids: set = set()
        self.cat_ids: set = set()

    # ------------------------------------------------------------- feeding
    def add_gt_annotations(self, anns: Sequence[dict], image_id: int) -> None:
        self.img_ids.add(image_id)
        for ann in anns:
            self.cat_ids.add(ann["category_id"])
            self.gts[(image_id, ann["category_id"])].append(ann)

    def add_detections(self, dets: Sequence[dict], image_id: int) -> None:
        self.img_ids.add(image_id)
        for d in dets:
            self.dts[(image_id, d["category_id"])].append(d)

    # ------------------------------------------------------------ evaluate
    def _iou(self, img_id: int, cat_id: int) -> dict:
        """Precompute the per-(image, category) eval record once: IoU matrix
        plus the numpy columns the vectorized per-category accumulate loop
        re-reads for every area range (areas, scores, base-ignore flags) —
        hoisting the dict->array conversion here is the val2017-scale win."""
        gts = self.gts.get((img_id, cat_id), [])
        dts = sorted(self.dts.get((img_id, cat_id), []),
                     key=lambda d: -d["score"])[:self.max_dets[-1]]
        n_d, n_g = len(dts), len(gts)
        rec = {
            "dt_scores": np.asarray([d["score"] for d in dts],
                                    dtype=np.float64),
            "dt_areas": np.asarray([d["area"] for d in dts],
                                   dtype=np.float64),
            "g_areas": np.asarray([g["area"] for g in gts],
                                  dtype=np.float64),
            "g_base_ignore": np.asarray(
                [bool(g.get("ignore")) or g.get("iscrowd", 0) == 1
                 for g in gts], dtype=bool),
            "g_ids": np.asarray([g.get("id", i + 1)
                                 for i, g in enumerate(gts)], dtype=np.int64),
        }
        if n_g == 0 or n_d == 0:
            rec["ious"] = np.zeros((n_d, n_g))
            return rec
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts])
        if self.iou_type == "bbox":
            d = np.asarray([dt["bbox"] for dt in dts], dtype=np.float64)
            g = np.asarray([gt["bbox"] for gt in gts], dtype=np.float64)
            rec["ious"] = bbox_iou_matrix(d, g, iscrowd)
        elif self.iou_type == "segm":
            # masks are stored as column-major RLE from the moment they
            # enter the evaluator (update/_ensure_gt), so val2017-scale
            # eval never holds dense full-image masks (pycocotools stores
            # RLE throughout, reference coco_eval_util.py:101-111)
            rec["ious"] = mask_rle.iou_matrix(
                [dt["rle"] for dt in dts], [gt["rle"] for gt in gts],
                np.asarray(iscrowd, np.int32))
        else:
            d = np.asarray([np.asarray(dt["keypoints"]).reshape(-1, 3)
                            for dt in dts])
            rec["ious"] = oks_matrix(d, gts)
        return rec

    # ----------------------------------------------------------- accumulate
    def accumulate(self):
        """Per-category accumulation, vectorized across images.

        pycocotools evaluates each (img, cat, area) record separately and
        concatenates per-record arrays at accumulate time; at val2017 scale
        most records are det-only (a detection category with no GT in that
        image) and the per-record Python overhead dominates.  Here each
        category keeps ONE set of concatenated det columns (image order);
        greedy matching runs only for records with both dets and gts, and
        the per-max_det truncation is a position-in-record mask, so the
        stable score sort sees exactly the per-record [:max_det] concat the
        published algorithm produces — results are identical."""
        cat_ids = sorted(self.cat_ids) or [1]
        n_thr, n_rec = len(IOU_THRS), len(REC_THRS)
        n_cat, n_area, n_md = len(cat_ids), len(self.area_labels), len(self.max_dets)
        precision = -np.ones((n_thr, n_rec, n_cat, n_area, n_md))
        recall = -np.ones((n_thr, n_cat, n_area, n_md))
        scores = -np.ones((n_thr, n_rec, n_cat, n_area, n_md))

        # (img, cat) pairs with neither gts nor dts contribute nothing;
        # skip them instead of iterating the full img x cat grid.
        active: Dict[int, list] = defaultdict(list)
        for (img, cat) in set(self.gts) | set(self.dts):
            active[cat].append(img)

        for c_i, cat in enumerate(cat_ids):
            imgs = sorted(active.get(cat, []))
            if not imgs:
                continue
            recs = [self._iou(img, cat) for img in imgs]
            n_ds = np.asarray([len(r["dt_scores"]) for r in recs],
                              dtype=np.int64)
            offsets = np.concatenate([[0], np.cumsum(n_ds)])
            d_tot = int(offsets[-1])
            if d_tot:
                dt_scores_cat = np.concatenate([r["dt_scores"] for r in recs])
                dt_areas_cat = np.concatenate([r["dt_areas"] for r in recs])
                pos_in_rec = np.concatenate(
                    [np.arange(n) for n in n_ds if n])
            else:
                dt_scores_cat = np.zeros(0)
                dt_areas_cat = np.zeros(0)
                pos_in_rec = np.zeros(0, dtype=np.int64)
            g_areas_cat = np.concatenate([r["g_areas"] for r in recs])
            g_base_ig_cat = np.concatenate([r["g_base_ignore"] for r in recs])

            for a_i, a_lbl in enumerate(self.area_labels):
                lo, hi = AREA_RNG[a_lbl]
                npig = int(((~g_base_ig_cat) & (g_areas_cat >= lo)
                            & (g_areas_cat <= hi)).sum())
                if npig == 0:
                    continue
                d_out = (dt_areas_cat < lo) | (dt_areas_cat > hi)
                dt_match_cat = np.zeros((n_thr, d_tot), dtype=np.int64)
                dt_ig_match = np.zeros((n_thr, d_tot), dtype=bool)
                for r_i, rec in enumerate(recs):
                    n_d, n_g = rec["ious"].shape
                    if n_d == 0 or n_g == 0:
                        continue
                    g_ignore = (rec["g_base_ignore"]
                                | (rec["g_areas"] < lo)
                                | (rec["g_areas"] > hi))
                    # sort gts: non-ignored first (stable), pycocotools
                    # gtind order
                    g_order = np.argsort(g_ignore, kind="mergesort")
                    g_ignore = g_ignore[g_order]
                    m_idx = match_greedy(rec["ious"][:, g_order], g_ignore,
                                         IOU_THRS)
                    matched = m_idx >= 0
                    g_ids = rec["g_ids"][g_order]
                    safe = np.clip(m_idx, 0, None)
                    cols = slice(offsets[r_i], offsets[r_i] + n_d)
                    dt_ig_match[:, cols] = np.where(matched, g_ignore[safe],
                                                    False)
                    dt_match_cat[:, cols] = np.where(matched, g_ids[safe], 0)
                # unmatched dets outside the area range are ignored
                dt_ignore_cat = dt_ig_match | ((dt_match_cat == 0)
                                               & d_out[None])

                for m_i, max_det in enumerate(self.max_dets):
                    sel = pos_in_rec < max_det
                    sc = dt_scores_cat[sel]
                    order = np.argsort(-sc, kind="mergesort")
                    sc = sc[order]
                    dtm = dt_match_cat[:, sel][:, order]
                    dti = dt_ignore_cat[:, sel][:, order]
                    n_gt = npig
                    tps = (dtm > 0) & ~dti
                    fps = (dtm == 0) & ~dti
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    rc_all = tp_sum / n_gt
                    pr_all = tp_sum / np.maximum(tp_sum + fp_sum, np.spacing(1))
                    # precision envelope (monotone non-increasing), all
                    # thresholds at once
                    pr_env = np.maximum.accumulate(
                        pr_all[:, ::-1], axis=1)[:, ::-1]
                    for t_i in range(n_thr):
                        rc = rc_all[t_i]
                        pr = pr_env[t_i]
                        recall[t_i, c_i, a_i, m_i] = rc[-1] if len(rc) else 0
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        valid = inds < len(pr)
                        q = np.zeros(n_rec)
                        s = np.zeros(n_rec)
                        q[valid] = pr[inds[valid]]
                        s[valid] = sc[inds[valid]]
                        precision[t_i, :, c_i, a_i, m_i] = q
                        scores[t_i, :, c_i, a_i, m_i] = s
        self.precision = precision
        self.recall = recall
        self.eval_scores = scores
        return self

    # ------------------------------------------------------------ summarize
    def _summ(self, ap: bool, iou_thr: Optional[float] = None,
              area: str = "all", max_det: int = 100) -> float:
        a_i = self.area_labels.index(area)
        m_i = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou_thr))]]
            s = s[:, :, :, a_i, m_i]
        else:
            s = self.recall
            if iou_thr is not None:
                s = s[[np.argmin(np.abs(IOU_THRS - iou_thr))]]
            s = s[:, :, a_i, m_i]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        md = self.max_dets[-1]
        if self.iou_type == "keypoints":
            stats = [
                self._summ(True, None, "all", md),
                self._summ(True, 0.5, "all", md),
                self._summ(True, 0.75, "all", md),
                self._summ(True, None, "medium", md),
                self._summ(True, None, "large", md),
                self._summ(False, None, "all", md),
                self._summ(False, 0.5, "all", md),
                self._summ(False, 0.75, "all", md),
                self._summ(False, None, "medium", md),
                self._summ(False, None, "large", md),
            ]
        else:
            stats = [
                self._summ(True, None, "all", md),
                self._summ(True, 0.5, "all", md),
                self._summ(True, 0.75, "all", md),
                self._summ(True, None, "small", md),
                self._summ(True, None, "medium", md),
                self._summ(True, None, "large", md),
                self._summ(False, None, "all", self.max_dets[0]),
                self._summ(False, None, "all",
                           self.max_dets[min(1, len(self.max_dets) - 1)]),
                self._summ(False, None, "all", md),
                self._summ(False, None, "small", md),
                self._summ(False, None, "medium", md),
                self._summ(False, None, "large", md),
            ]
        self.stats = np.asarray(stats)
        return self.stats


class CocoEvaluator:
    """Streaming evaluator fed per-image predictions (the reference's
    CocoEvaluator.update / synchronize / accumulate / summarize protocol,
    src/utils/coco_eval_util.py:15-150)."""

    def __init__(self, dataset: CocoDataset, iou_types: Sequence[str]):
        self.dataset = dataset
        self.iou_types = list(iou_types)
        self.evals = {t: COCOEvalNP(t) for t in self.iou_types}
        self._gt_loaded: set = set()

    def _ensure_gt(self, image_id: int) -> None:
        if image_id in self._gt_loaded:
            return
        self._gt_loaded.add(image_id)
        anns = self.dataset.anns_by_img.get(image_id, [])
        info = self.dataset.images[image_id]
        for t, ev in self.evals.items():
            gt_list = []
            for ann in anns:
                g = {"id": ann["id"], "category_id": ann["category_id"],
                     "bbox": list(ann["bbox"]), "area": ann["area"],
                     "iscrowd": ann.get("iscrowd", 0)}
                if t == "segm":
                    # rasterize transiently, store RLE only (bounded memory
                    # at val2017 scale); rle area == dense mask sum
                    dense = ann_to_mask(ann, info["height"], info["width"])
                    g["rle"] = mask_rle.encode(dense)
                    # segm eval measures mask area
                    g["area"] = float(mask_rle.area(g["rle"])) \
                        if "segmentation" in ann else ann["area"]
                if t == "keypoints":
                    if "keypoints" not in ann:
                        continue
                    g["keypoints"] = ann["keypoints"]
                    g["ignore"] = ann.get("num_keypoints", 0) == 0
                gt_list.append(g)
            ev.add_gt_annotations(gt_list, image_id)

    def update(self, predictions: Dict[int, Dict[str, np.ndarray]]) -> None:
        """predictions: {image_id: {'boxes' xyxy original coords, 'scores',
        'labels', optional 'masks' [N, H, W] uint8, 'keypoints' [N, 17, 3]}}"""
        for image_id, pred in predictions.items():
            self._ensure_gt(image_id)
            boxes = np.asarray(pred["boxes"], dtype=np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            scores = np.asarray(pred["scores"], dtype=np.float64)
            labels = np.asarray(pred["labels"], dtype=np.int64)
            for t, ev in self.evals.items():
                dets = []
                for i in range(len(boxes)):
                    d = {"id": i + 1, "category_id": int(labels[i]),
                         "bbox": xywh[i].tolist(), "score": float(scores[i]),
                         "area": float(xywh[i, 2] * xywh[i, 3])}
                    if t == "segm":
                        d["rle"] = mask_rle.encode(
                            np.asarray(pred["masks"][i], dtype=np.uint8))
                        d["area"] = float(mask_rle.area(d["rle"]))
                    if t == "keypoints":
                        d["keypoints"] = np.asarray(
                            pred["keypoints"][i]).reshape(-1).tolist()
                    dets.append(d)
                ev.add_detections(dets, image_id)

    def synchronize_between_processes(self) -> None:
        """Merge the ranks' evaluator state (JAX's merge,
        hnd_ghnd_tpu/evals/coco_eval.py:481-510; the reference's pickle
        all_gather and image-id dedup, src/utils/coco_eval_util.py:158-177).

        Each rank contributes the images it evaluated; an image that two
        ranks hold (a shard's wrap-around, a replicated eval) keeps the
        lowest rank's copy.  Every rank then holds the full set, so
        ``accumulate``/``summarize`` agree everywhere.  One process: nothing
        to merge."""
        if multihost.get_world_size() == 1:
            return
        payload = {t: (dict(ev.gts), dict(ev.dts), set(ev.img_ids),
                       set(ev.cat_ids))
                   for t, ev in self.evals.items()}
        gathered = multihost.all_gather_objects(payload)
        for t, ev in self.evals.items():
            m_gts: Dict = {}
            m_dts: Dict = {}
            img_ids: set = set()
            cat_ids: set = set()
            for proc in gathered:
                gts, dts, imgs, cats = proc[t]
                fresh = imgs - img_ids
                for key, v in gts.items():
                    if key[0] in fresh:
                        m_gts[key] = v
                for key, v in dts.items():
                    if key[0] in fresh:
                        m_dts[key] = v
                img_ids |= fresh
                cat_ids |= cats
            ev.gts = defaultdict(list, m_gts)
            ev.dts = defaultdict(list, m_dts)
            ev.img_ids = img_ids
            ev.cat_ids = cat_ids

    def accumulate(self) -> None:
        for ev in self.evals.values():
            ev.accumulate()

    def summarize(self) -> Dict[str, np.ndarray]:
        out = {}
        for t, ev in self.evals.items():
            out[t] = ev.summarize()
            print(f"IoU metric: {t}")
            print(f"  mAP @[.5:.95]: {out[t][0]:.4f}  "
                  f"mAP@.5: {out[t][1]:.4f}  mAP@.75: {out[t][2]:.4f}")
        self.stats = out
        return out
