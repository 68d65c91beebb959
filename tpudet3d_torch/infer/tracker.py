"""IoU tracker with EMA keypoint smoothing (copy of
``tpudet3d/infer/tracker.py``; host numpy).

Hungarian assignment on a 0.5·(1−GIoU) cost (the native LAPJV solver of
``tpudet3d_torch/native.py``, or scipy without a compiler), per-track EMA
smoothing of boxes (speed 0.7) and keypoints (speed 0.3) gated by an ADD
threshold with a stale-track override, linear interpolation over short
gaps, optional greedy keypoint re-alignment, track lifecycle with an ID
pool, and a window filter for reporting.
"""

from collections import namedtuple
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..native import giou_cost_matrix, linear_assignment

__all__ = ['Track', 'IOUTracker', 'TrackedObj', 'IOUTrackerConfig']

TrackedObj = namedtuple('TrackedObj', 'rect kp label')


@dataclass
class IOUTrackerConfig:
    time_window: int = 10
    continue_time_thresh: int = 5
    track_clear_thresh: int = 3000
    match_threshold: float = 0.4
    track_detection_iou_thresh: float = 0.5
    interpolate_time_thresh: float = 10
    detection_filter_speed: float = 0.7
    keypoints_filter_speed: float = 0.3
    add_treshold: float = 0.1
    no_updated_frames_treshold: int = 5
    align_kp: bool = False


def _iou(b1, b2):
    inter_w = max(min(b1[2], b2[2]) - max(b1[0], b2[0]), 0)
    inter_h = max(min(b1[3], b2[3]) - max(b1[1], b2[1]), 0)
    inter = inter_w * inter_h
    a1 = max(b1[2] - b1[0], 0) * max(b1[3] - b1[1], 0)
    a2 = max(b2[2] - b2[0], 0) * max(b2[3] - b2[1], 0)
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


class Track:
    """History of one tracked object with EMA smoothing."""

    def __init__(self, track_id, box, kps, timestamp, align_kp=False):
        self.id = track_id
        self.boxes = [tuple(box)]
        self.kps = [np.asarray(kps, np.float64).reshape(-1, 2)]
        self.timestamps = [timestamp]
        self.stale_frames = 0
        self.align_kp = align_kp

    def __len__(self):
        return len(self.timestamps)

    @property
    def last_box(self):
        return self.boxes[-1]

    @property
    def last_kp(self):
        return self.kps[-1]

    @property
    def end_time(self):
        return self.timestamps[-1]

    def _interpolate_gap(self, box, kps, skip):
        prev_box = np.asarray(self.boxes[-1], np.float64)
        prev_kp = self.kps[-1]
        box = np.asarray(box, np.float64)
        for t in range(1, skip):
            frac = t / skip
            self.boxes.append(tuple((prev_box + (box - prev_box) * frac)
                                    .astype(int).tolist()))
            self.kps.append(prev_kp + (kps - prev_kp) * frac)
            self.timestamps.append(self.timestamps[-1] + 1)

    def _greedy_realign(self, kp_new, kp_prev):
        """Greedy pairwise vertex swap reducing per-vertex drift (reference
        tracking_tools.py:77-102 capability)."""
        n = kp_new.shape[0]
        order = list(range(n))
        swapped = [False] * n
        for i in range(n):
            if swapped[i]:
                continue
            best_j, best_d = i, np.linalg.norm(kp_new[i] - kp_prev[i])
            for j in range(i + 1, n):
                d = np.linalg.norm(kp_new[i] - kp_prev[j])
                if d < best_d:
                    best_j, best_d = j, d
            if best_j != i and not swapped[best_j]:
                order[i], order[best_j] = best_j, i
                swapped[i] = swapped[best_j] = True
        return kp_new[order]

    def _smooth_kp(self, speed, add_thr, stale_thr):
        if self.timestamps[-1] - self.timestamps[-2] != 1:
            return
        prev = self.kps[-2]
        cur = self.kps[-1]
        add = float(np.mean(np.linalg.norm(cur - prev, axis=1)))
        if self.align_kp:
            realigned = self._greedy_realign(cur, prev)
            add_re = float(np.mean(np.linalg.norm(realigned - prev, axis=1)))
            if add_re < add:
                cur, add = realigned, add_re
        if add < add_thr:
            self.stale_frames = 0
            self.kps[-1] = (1 - speed) * prev + speed * cur
        elif self.stale_frames > stale_thr:
            self.kps[-1] = cur          # jump: EMA interrupted
        else:
            self.kps[-1] = prev         # hold previous estimate
            self.stale_frames += 1

    def _smooth_box(self, speed):
        if self.timestamps[-1] - self.timestamps[-2] != 1:
            return
        prev = np.asarray(self.boxes[-2], np.float64)
        cur = np.asarray(self.boxes[-1], np.float64)
        self.boxes[-1] = tuple(((1 - speed) * prev + speed * cur)
                               .astype(int).tolist())

    def update(self, box, kps, timestamp, max_skip=1, box_speed=0.7,
               kp_speed=0.3, add_thr=0.1, stale_thr=5):
        kps = np.asarray(kps, np.float64).reshape(-1, 2)
        skip = timestamp - self.end_time
        if 1 < skip <= max_skip:
            self._interpolate_gap(box, kps, skip)
        self.boxes.append(tuple(box))
        self.kps.append(kps)
        self.timestamps.append(timestamp)
        self._smooth_box(box_speed)
        self._smooth_kp(kp_speed, add_thr, stale_thr)


class IOUTracker:
    """Multi-object tracker: Hungarian GIoU matching + track lifecycle."""

    def __init__(self, time_window=5, continue_time_thresh=2,
                 track_clear_thresh=3000, match_threshold=0.4,
                 track_detection_iou_thresh=0.5, interpolate_time_thresh=10,
                 detection_filter_speed=0.7, keypoints_filter_speed=0.3,
                 add_treshold=0.1, no_updated_frames_treshold=5,
                 align_kp=False):
        self.time_window = time_window
        self.continue_time_thresh = continue_time_thresh
        self.track_clear_thresh = track_clear_thresh
        self.match_threshold = match_threshold
        self.track_detection_iou_thresh = track_detection_iou_thresh
        self.interpolate_time_thresh = interpolate_time_thresh
        self.detection_filter_speed = detection_filter_speed
        self.keypoints_filter_speed = keypoints_filter_speed
        self.add_treshold = add_treshold
        self.no_updated_frames_treshold = no_updated_frames_treshold
        self.align_kp = align_kp

        self.tracks: List[Track] = []
        self.history_tracks: List[Track] = []
        self.time = 0
        self._free_ids: List[int] = []
        self._next_id = 0

    # --- id pool ---------------------------------------------------------
    def _acquire_id(self):
        if self._free_ids:
            return self._free_ids.pop()
        self._next_id += 1
        return self._next_id - 1

    def _release_id(self, track_id):
        self._free_ids.append(track_id)

    # --- main step ---------------------------------------------------------
    def process(self, frame, detections, kps):
        """detections: list of (x1,y1,x2,y2[,score,label]); kps: flat lists."""
        del frame
        assignment = self._match(detections, kps)
        for det_i, trk_i in enumerate(assignment):
            if trk_i is None:
                self.tracks.append(Track(self._acquire_id(),
                                         detections[det_i][:4], kps[det_i],
                                         self.time, self.align_kp))
        self._prune()
        self.time += 1

    def _match(self, detections, kps):
        active = [i for i, t in enumerate(self.tracks)
                  if t.end_time >= self.time - self.continue_time_thresh]
        assignment: List[Optional[int]] = [None] * len(detections)
        if active and detections:
            det_boxes = np.asarray([d[:4] for d in detections], np.float64)
            trk_boxes = np.asarray([self.tracks[i].last_box for i in active],
                                   np.float64)
            cost = giou_cost_matrix(det_boxes, trk_boxes)
            rows, cols = linear_assignment(cost)
            for r, c in zip(rows, cols):
                track = self.tracks[active[c]]
                if cost[r, c] < self.match_threshold and \
                        _iou(track.last_box, detections[r][:4]) > \
                        self.track_detection_iou_thresh:
                    assignment[r] = c
                    track.update(detections[r][:4], kps[r], self.time,
                                 self.continue_time_thresh,
                                 self.detection_filter_speed,
                                 self.keypoints_filter_speed,
                                 self.add_treshold,
                                 self.no_updated_frames_treshold)
        return assignment

    def _prune(self):
        remaining = []
        for track in self.tracks:
            if track.end_time < self.time - self.track_clear_thresh:
                self.history_tracks.append(track)
            elif track.end_time < self.time - self.continue_time_thresh and \
                    len(track) < self.time_window:
                self._release_id(track.id)
            else:
                remaining.append(track)
        self.tracks = remaining

    # --- reporting ---------------------------------------------------------
    def get_tracked_objects(self):
        objs = []
        for track in self.tracks:
            if track.end_time != self.time - 1:
                continue
            label = (f'ID {track.id}' if len(track) > self.time_window
                     else 'ID -1')
            objs.append(TrackedObj(track.last_box,
                                   tuple(track.last_kp.reshape(-1).tolist()),
                                   label))
        return objs

    def get_tracks(self):
        return self.tracks

    def get_archived_tracks(self):
        return self.history_tracks
