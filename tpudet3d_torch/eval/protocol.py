"""Objectron evaluation protocol (counterpart of ``tpudet3d/eval/protocol.py``).

The host bookkeeping is the JAX package's, copied: the ``HitMiss`` /
``AveragePrecision`` accumulators (per-example hit/miss lists, cumulative
PR curve, VOC-2012 interpolated AP normalised by the total GT instance
count), the vendor's prediction-major evaluate loop (each prediction
matches the nearest visible GT by summed squared 2D keypoint distance;
unmatched predictions score the max-error sentinels), the metrics (3D IoU,
normalised 2D vertex error, viewpoint azimuth/polar errors, ADD / ADD-S
with ground-plane scale recovery), the report format, and a pure-python
TFRecord reader and ``tf.train.Example`` parser.  docs/protocol_derivation.md
maps the reconstructed vendor symbols to the published Objectron code.

Two numeric details follow the JAX program, which runs with x64 off:
``fit_box`` computes the box axes in float32, and every 3D IoU is a
float32 value from kernel K5 (``ops/box3d.py``).

One change of form, not of result: the JAX loop calls K5 once per matched
prediction.  Here the IoUs of all matched predictions of an example are
computed in one K5 call on the evaluator's device before the hit/miss
loop, which then records them in the same order.

Known vendor artifact (preserved): recall = tp / total_GT_instances is not
clamped, so when predictions outnumber GT instances per-bin AP can exceed 1.
"""

import struct
import time

import numpy as np
import torch

from ..core.crc32c import masked_crc32c
from ..core.device import resolve_device
from ..data.converter.proto import _read_varint, _skip, decode_message
from ..ops.box3d import box_axes, iou_oriented_boxes

__all__ = ['HitMiss', 'AveragePrecision', 'ObjectronProtocolEvaluator',
           'read_tfrecord', 'parse_example', 'compute_scale',
           'compute_viewpoint', 'viewpoint_errors', 'match_box',
           'is_visible', 'fit_box', 'iou_2d_extents', 'MAX_PIXEL_ERROR',
           'MAX_AZIMUTH_ERROR', 'MAX_POLAR_ERROR', 'MAX_DISTANCE',
           'NUM_BINS']

# protocol constants (vendor objectron.dataset.metrics defaults)
MAX_PIXEL_ERROR = 20.0
MAX_AZIMUTH_ERROR = 30.0
MAX_POLAR_ERROR = 20.0
MAX_DISTANCE = 1.0
NUM_BINS = 21


class HitMiss:
    """Hit/miss counts across a threshold sweep (vendor
    objectron.dataset.metrics.HitMiss semantics: one instance per call of
    ``record_hit_miss``, a hit at threshold t iff metric >= t — or <= t for
    error metrics, ``greater=False``)."""

    def __init__(self, thresholds):
        self.thresholds = np.asarray(thresholds, np.float64)
        self.size = len(self.thresholds)
        self.hit = np.zeros(self.size)
        self.miss = np.zeros(self.size)

    def reset(self):
        self.hit = np.zeros(self.size)
        self.miss = np.zeros(self.size)

    def record_hit_miss(self, metric, greater=True):
        if greater:
            hits = metric >= self.thresholds
        else:
            hits = metric <= self.thresholds
        self.hit += hits
        self.miss += ~hits


class AveragePrecision:
    """Per-threshold AP over per-example hit/miss curves (vendor
    objectron.dataset.metrics.AveragePrecision semantics, used by the
    reference at objectron_eval.py:169-175: ``append(hit_miss,
    len(instances))`` per example, AP normalized by the total GT instance
    count).  The precision/recall curve accumulates examples in append
    order; AP integrates the monotone precision envelope over recall steps
    (Pascal VOC 2012 style)."""

    def __init__(self, num_bins=NUM_BINS):
        self.size = num_bins
        self.aps = np.zeros(num_bins)
        self.true_positive = [[] for _ in range(num_bins)]
        self.false_positive = [[] for _ in range(num_bins)]
        self._total_instances = 0.0

    def append(self, hit_miss, num_instances):
        for i in range(self.size):
            self.true_positive[i].append(hit_miss.hit[i])
            self.false_positive[i].append(hit_miss.miss[i])
        self._total_instances += num_instances

    @staticmethod
    def compute_ap(recall, precision):
        """VOC-2012 interpolated AP: clamp precision to its running max from
        the right, integrate over recall increments."""
        recall = np.concatenate(([0.], recall, [1.]))
        precision = np.concatenate(([0.], precision, [0.]))
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        idx = np.where(recall[1:] != recall[:-1])[0] + 1
        return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))

    def compute_ap_curve(self):
        for i in range(self.size):
            tp = np.cumsum(self.true_positive[i], dtype=np.float64)
            fp = np.cumsum(self.false_positive[i], dtype=np.float64)
            if len(tp) == 0 or self._total_instances <= 0:
                self.aps[i] = 0.0
                continue
            precision = tp / np.maximum(tp + fp, 1e-12)
            recall = tp / self._total_instances
            self.aps[i] = self.compute_ap(recall, precision)
        return self.aps


def fit_box(vertices9):
    """9 keypoints → (rotation [3,3], translation [3], scale [3]), from the
    box axes in float32."""
    center, axes = box_axes(torch.as_tensor(np.asarray(vertices9),
                                            dtype=torch.float32))
    axes = axes.numpy()
    center = center.numpy()
    norms = np.linalg.norm(axes, axis=-1)
    rot = axes / np.maximum(norms[:, None], 1e-12)
    return rot.T, center, 2.0 * norms   # columns = box axes


def compute_scale(box_vertices9, plane):
    """Ground-plane scale recovery (vendor Evaluator.compute_scale):
    scale = mean over the 4 plane-nearest vertices of
    (plane_center·n) / (vertex·n)."""
    center, normal = plane
    verts = np.asarray(box_vertices9)[1:]
    dots = np.sort(verts @ np.asarray(normal))
    center_dot = float(np.dot(center, normal))
    denom = dots[:4]
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    return float(np.mean(center_dot / denom))


def compute_viewpoint(box_vertices9):
    """(azimuth°, polar°) of the camera→box-centroid ray in box coordinates
    (vendor Evaluator.compute_viewpoint/compute_ray: the camera sits at the
    origin of the camera frame; the ray to the box center, expressed in the
    box frame, gives spherical viewpoint angles θ = atan2(z, x),
    φ = atan2(y, hypot(x, z)), range (−180, 180])."""
    rot, center, _scale = fit_box(np.asarray(box_vertices9, np.float64))
    x, y, z = rot.T @ center            # camera ray in box coordinates
    theta = np.degrees(np.arctan2(z, x))
    phi = np.degrees(np.arctan2(y, np.hypot(x, z)))
    return float(theta), float(phi)


def viewpoint_errors(box_pred9, box_gt9):
    """(azimuth_err°, polar_err°) between predicted and GT viewpoints
    (vendor Evaluator.evaluate_viewpoint: absolute angle differences,
    azimuth wrapped to [0, 180])."""
    az_p, pol_p = compute_viewpoint(box_pred9)
    az_g, pol_g = compute_viewpoint(box_gt9)
    azimuth = abs(az_p - az_g)
    if azimuth > 180.0:
        azimuth = 360.0 - azimuth
    return azimuth, abs(pol_p - pol_g)


def is_visible(point_2d):
    """Vendor Evaluator._is_visible: projected center inside the frame."""
    return 0.0 < point_2d[0] < 1.0 and 0.0 < point_2d[1] < 1.0


def iou_2d_extents(kp_a, kp_b):
    """Axis-aligned IoU of the 2D extents of two keypoint sets."""
    kp_a, kp_b = np.asarray(kp_a), np.asarray(kp_b)
    a0, a1 = kp_a.min(0), kp_a.max(0)
    b0, b1 = kp_b.min(0), kp_b.max(0)
    lt = np.maximum(a0, b0)
    rb = np.minimum(a1, b1)
    inter = np.prod(np.clip(rb - lt, 0, None))
    union = np.prod(a1 - a0) + np.prod(b1 - b0) - inter
    return float(inter / union) if union > 0 else 0.0


def match_box(pred_kp_2d, gt_kp_sets_2d, visibilities, vis_thresh=0.1):
    """Nearest GT instance for a predicted 2D keypoint set, or −1.

    Published Objectron ``Evaluator.match_box`` semantics (vendor
    objectron/dataset/eval.py; see docs/protocol_derivation.md §match_box):
    every prediction is matched to the *nearest* annotation by Frobenius
    norm over the 9 keypoints — "we always assume a match for a
    prediction" — and −1 (→ max-error penalty in the caller, reference
    objectron_eval.py:154-160) only when that nearest instance fails the
    visibility threshold.  There is NO overlap floor: a wild prediction
    matches its nearest visible GT and records its (terrible) true
    metrics instead of the sentinels."""
    if not len(gt_kp_sets_2d):
        return -1
    pred = np.asarray(pred_kp_2d, np.float64)
    norms = [np.linalg.norm(np.asarray(g, np.float64) - pred)
             for g in gt_kp_sets_2d]
    index = int(np.argmin(norms))
    if visibilities[index] <= vis_thresh:   # vendor accepts only vis > thresh
        return -1
    return index


class ObjectronProtocolEvaluator:
    """Accumulates the official metric suite for one category.

    The 3D IoUs run through K5 on ``device`` (the card unless ``'cpu'``);
    ``iou_seconds`` adds up the wall time of those calls, the copy of their
    result to the host included, and ``num_examples`` counts the examples
    evaluated."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.iou_seconds = 0.0
        self.num_examples = 0
        self._ap_iou = AveragePrecision()
        self._ap_pixel = AveragePrecision()
        self._ap_azimuth = AveragePrecision()
        self._ap_polar = AveragePrecision()
        self._ap_add = AveragePrecision()
        self._ap_adds = AveragePrecision()
        # Dedup variant (NOT the vendor protocol): at most ONE prediction —
        # the best 2D-extent-IoU match — may score per GT instance, so
        # accumulated hits can never exceed the instance count and AP stays
        # in [0, 1].  Bounds the preserved vendor artifact where duplicate
        # detections push per-bin AP past 1 (see module docstring); the
        # vendor-exact numbers above remain the default/report headline.
        self._ap_iou_dedup = AveragePrecision()
        self._ap_add_dedup = AveragePrecision()
        self._iou_thresholds = np.linspace(0.0, 1.0, NUM_BINS)
        self._pixel_thresholds = np.linspace(0.0, MAX_PIXEL_ERROR, NUM_BINS)
        self._azimuth_thresholds = np.linspace(0.0, MAX_AZIMUTH_ERROR, NUM_BINS)
        self._polar_thresholds = np.linspace(0.0, MAX_POLAR_ERROR, NUM_BINS)
        self._add_thresholds = np.linspace(0.0, MAX_DISTANCE, NUM_BINS)
        self._matched = 0
        self._total_gt = 0
        self._sum_iou = 0.0
        self._sum_pixel = 0.0
        self._sum_azimuth = 0.0
        self._sum_polar = 0.0

    def evaluate_example(self, pred_kp_sets_2d, pred_kp_sets_3d,
                         gt_kp_sets_2d, gt_kp_sets_3d, plane=None,
                         visibilities=None, vis_thresh=0.1):
        """pred/gt: lists of ([9,2] normalized 2D, [9,3] 3D) keypoint sets.

        Vendor-exact loop structure (reference objectron_eval.py:116-175):
        skip the example when no GT instance is visible (vis > thresh,
        projected center in frame, center z < 0); iterate *predictions*,
        match each to the nearest visible GT (multiple predictions may hit
        the same GT — no dedup, like the vendor); unmatched predictions are
        penalized with the max-error sentinels; one HitMiss per metric per
        *example*; AP accumulators are appended with ``len(instances)``
        (ALL annotated instances, not just visible ones)."""
        self.num_examples += 1
        instances = [np.asarray(g, np.float64) for g in gt_kp_sets_2d]
        instances_3d = [np.asarray(g, np.float64) for g in gt_kp_sets_3d]
        if visibilities is None:
            visibilities = np.ones(len(instances))
        self._total_gt += len(instances)

        num_visible = sum(
            1 for inst, inst3d, v in
            zip(instances, instances_3d, visibilities)
            if v > vis_thresh and is_visible(inst[0]) and inst3d[0, 2] < 0)
        if num_visible == 0:
            return    # vendor: "We don't have negative examples" (:128-129)

        hm_iou = HitMiss(self._iou_thresholds)
        hm_pixel = HitMiss(self._pixel_thresholds)
        hm_az = HitMiss(self._azimuth_thresholds)
        hm_pol = HitMiss(self._polar_thresholds)
        hm_add = HitMiss(self._add_thresholds)
        hm_adds = HitMiss(self._add_thresholds)
        hm_iou_dd = HitMiss(self._iou_thresholds)
        hm_add_dd = HitMiss(self._add_thresholds)

        preds = [(np.asarray(p2, np.float64), np.asarray(p3, np.float64))
                 for p2, p3 in zip(pred_kp_sets_2d, pred_kp_sets_3d)]
        match_idx = [match_box(p2, instances, visibilities, vis_thresh)
                     for p2, _ in preds]
        # dedup winners: nearest prediction per matched GT (same Frobenius
        # criterion match_box uses)
        best = {}
        for pi, mi in enumerate(match_idx):
            if mi >= 0:
                q = float(np.linalg.norm(preds[pi][0] - instances[mi]))
                if mi not in best or q < best[mi][0]:
                    best[mi] = (q, pi)
        dedup_keep = {pi for _, pi in best.values()}

        # ground-plane rescale, then the IoUs of all matched predictions in
        # one K5 call (the JAX loop makes one call per prediction)
        scaled = [p3d * compute_scale(p3d, plane) if plane is not None
                  and index >= 0 else p3d
                  for (_, p3d), index in zip(preds, match_idx)]
        pairs = [(scaled[pi], instances_3d[index])
                 for pi, index in enumerate(match_idx) if index >= 0]
        ious = iter(self._ious(pairs))

        num_matched = 0
        for pi, ((p2d, _), index) in enumerate(zip(preds, match_idx)):
            if index >= 0:
                num_matched += 1
                p3d = scaled[pi]
                g2d, g3d = instances[index], instances_3d[index]
                # vendor evaluate_2d: mean normalized distance over the 8
                # vertices (keypoint 0 = center excluded)
                pixel = float(np.mean(
                    np.linalg.norm(p2d[1:] - g2d[1:], axis=-1)))
                azimuth, polar = viewpoint_errors(p3d, g3d)
                iou = float(next(ious))
                add = float(np.mean(np.linalg.norm(p3d - g3d, axis=-1)))
                pair = np.linalg.norm(p3d[:, None] - g3d[None, :], axis=-1)
                adds = float(np.mean(pair.min(axis=1)))
                self._sum_iou += iou
                self._sum_pixel += pixel
                self._sum_azimuth += azimuth
                self._sum_polar += polar
            else:
                pixel = MAX_PIXEL_ERROR
                azimuth = MAX_AZIMUTH_ERROR
                polar = MAX_POLAR_ERROR
                iou = 0.0
                add = adds = MAX_DISTANCE
            hm_iou.record_hit_miss(iou)
            hm_pixel.record_hit_miss(pixel, greater=False)
            hm_az.record_hit_miss(azimuth, greater=False)
            hm_pol.record_hit_miss(polar, greater=False)
            hm_add.record_hit_miss(add, greater=False)
            hm_adds.record_hit_miss(adds, greater=False)
            # dedup: duplicate matches are dropped entirely; unmatched
            # predictions still count (they are genuine false positives)
            if index < 0 or pi in dedup_keep:
                hm_iou_dd.record_hit_miss(iou)
                hm_add_dd.record_hit_miss(add, greater=False)

        n_inst = len(instances)
        self._ap_iou.append(hm_iou, n_inst)
        self._ap_pixel.append(hm_pixel, n_inst)
        self._ap_azimuth.append(hm_az, n_inst)
        self._ap_polar.append(hm_pol, n_inst)
        self._ap_add.append(hm_add, n_inst)
        self._ap_adds.append(hm_adds, n_inst)
        self._ap_iou_dedup.append(hm_iou_dd, n_inst)
        self._ap_add_dedup.append(hm_add_dd, n_inst)
        self._matched += num_matched

    def _ious(self, pairs):
        """float32 IoUs of ``[(pred [9,3], gt [9,3]), ...]`` in one call."""
        if not pairs:
            return np.zeros((0,), np.float32)
        t0 = time.perf_counter()
        kp = torch.as_tensor(np.asarray(pairs), dtype=torch.float32)
        kp = kp.to(self.device)
        out = iou_oriented_boxes(kp[:, 0].contiguous(), kp[:, 1].contiguous())
        out = out.cpu().numpy()
        self.iou_seconds += time.perf_counter() - t0
        return out

    def finalize(self):
        for ap in (self._ap_iou, self._ap_pixel, self._ap_azimuth,
                   self._ap_polar, self._ap_add, self._ap_adds,
                   self._ap_iou_dedup, self._ap_add_dedup):
            ap.compute_ap_curve()

    def write_report(self, category, stream=None):
        """Vendor report format (reference objectron_eval.py:179-237):
        mean errors normalized by the matched count, then per metric a
        threshold line and an AP line.  The pixel/azimuth/polar threshold
        *display* is scaled by 0.1 exactly like the reference (:211, :217,
        :223) — a vendor quirk preserved for byte-comparable reports."""
        import sys
        stream = stream or sys.stdout

        def safe_div(a, b):
            return a / b if b else 0.0

        def report_array(label, array):
            stream.write(label)
            for val in array:
                stream.write('{:.4f},\t'.format(val))
            stream.write('\n')

        def thresh_line(label, thresholds, display_scale=1.0):
            stream.write(label)
            for t in thresholds:
                stream.write('{:.4f},\t'.format(t * display_scale))
            stream.write('\n')

        stream.write(f'Report for category {category} '
                     f'(matched {self._matched}/{self._total_gt})\n')
        stream.write('Mean Error 2D: {}\n'.format(
            safe_div(self._sum_pixel, self._matched)))
        stream.write('Mean 3D IoU: {}\n'.format(
            safe_div(self._sum_iou, self._matched)))
        stream.write('Mean Azimuth Error: {}\n'.format(
            safe_div(self._sum_azimuth, self._matched)))
        stream.write('Mean Polar Error: {}\n'.format(
            safe_div(self._sum_polar, self._matched)))
        stream.write('\n')
        thresh_line('IoU Thresholds: ', self._iou_thresholds)
        report_array('AP @3D IoU    : ', self._ap_iou.aps)
        stream.write('\n')
        thresh_line('2D Thresholds : ', self._pixel_thresholds, 0.1)
        report_array('AP @2D Pixel  : ', self._ap_pixel.aps)
        stream.write('\n')
        thresh_line('Azimuth Thresh: ', self._azimuth_thresholds, 0.1)
        report_array('AP @Azimuth   : ', self._ap_azimuth.aps)
        stream.write('\n')
        thresh_line('Polar Thresh  : ', self._polar_thresholds, 0.1)
        report_array('AP @Polar     : ', self._ap_polar.aps)
        stream.write('\n')
        thresh_line('ADD Thresh    : ', self._add_thresholds)
        report_array('AP @ADD       : ', self._ap_add.aps)
        stream.write('\n')
        thresh_line('ADDS Thresh   : ', self._add_thresholds)
        report_array('AP @ADDS      : ', self._ap_adds.aps)
        # NON-vendor extension (clearly separated below the vendor-exact
        # report): best-prediction-per-GT dedup APs, bounded to [0, 1] —
        # the headline can't be inflated by duplicate detections
        stream.write('\nDedup variant (best prediction per GT; '
                     'not part of the vendor protocol):\n')
        report_array('AP Dedup @3D IoU: ', self._ap_iou_dedup.aps)
        report_array('AP Dedup @ADD   : ', self._ap_add_dedup.aps)


# --- TFRecord + tf.train.Example parsing (no TensorFlow) -------------------

def read_tfrecord(path, verify_crc=False):
    """Yield raw record payloads from a TFRecord file.

    By default CRCs are skipped (tolerant reader, matches tf.data's
    default-off experimental_deterministic checksum behavior for speed);
    ``verify_crc=True`` checks both masked CRC32C fields exactly like
    tf.data.TFRecordDataset does and raises ValueError on corruption."""
    with open(path, 'rb') as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack('<Q', header[:8])
            payload = f.read(length)
            data_crc = f.read(4)
            if len(payload) < length:
                return
            if verify_crc:
                (lcrc,) = struct.unpack('<I', header[8:12])
                if lcrc != masked_crc32c(header[:8]):
                    raise ValueError(f'{path}: bad length CRC')
                (dcrc,) = struct.unpack('<I', data_crc)
                if dcrc != masked_crc32c(payload):
                    raise ValueError(f'{path}: bad data CRC')
            yield payload


_FEATURE_SCHEMA = {
    1: ('bytes[]', 'string_bytes', None),
    2: ('floats', 'message', {1: ('value[]', 'float', None)}),
    3: ('ints', 'message', {1: ('value[]', 'varint', None)}),
}


def _decode_feature(buf):
    out = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:    # BytesList
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            spos = 0
            vals = []
            while spos < len(sub):
                stag, spos = _read_varint(sub, spos)
                sln, spos = _read_varint(sub, spos)
                vals.append(sub[spos:spos + sln])
                spos += sln
            out['bytes'] = vals
        elif field == 2 and wire == 2:  # FloatList
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            vals = decode_message(sub, {1: ('value[]', 'float', None)})
            out['floats'] = vals.get('value', [])
        elif field == 3 and wire == 2:  # Int64List
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            vals = decode_message(sub, {1: ('value[]', 'varint', None)})
            out['ints'] = vals.get('value', [])
        else:
            pos = _skip(buf, pos, wire)
    return out


def parse_example(payload):
    """tf.train.Example bytes → {feature_name: {'bytes'|'floats'|'ints'}}."""
    features = {}

    def walk_features(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:   # map entry
                ln, pos = _read_varint(buf, pos)
                entry = buf[pos:pos + ln]
                pos += ln
                epos = 0
                key, val = None, None
                while epos < len(entry):
                    etag, epos = _read_varint(entry, epos)
                    ef, ew = etag >> 3, etag & 7
                    if ef == 1 and ew == 2:
                        ln2, epos = _read_varint(entry, epos)
                        key = entry[epos:epos + ln2].decode()
                        epos += ln2
                    elif ef == 2 and ew == 2:
                        ln2, epos = _read_varint(entry, epos)
                        val = _decode_feature(entry[epos:epos + ln2])
                        epos += ln2
                    else:
                        epos = _skip(entry, epos, ew)
                if key is not None:
                    features[key] = val or {}
            else:
                pos = _skip(buf, pos, wire)

    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:       # Features
            ln, pos = _read_varint(payload, pos)
            walk_features(payload[pos:pos + ln])
            pos += ln
        else:
            pos = _skip(payload, pos, wire)
    return features
