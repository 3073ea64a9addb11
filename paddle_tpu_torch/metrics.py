"""Host-side metric accumulators (ref python/paddle/fluid/metrics.py:
MetricBase, Accuracy, CompositeMetric, EditDistance, Auc, DetectionMAP).

A copy of paddle_tpu/metrics.py (numpy only; the port imports nothing of
the JAX package).  They run on host arrays, such as the probabilities a
Predictor returns: ``Auc`` is the CTR models' metric."""
from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * float(weight)
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError("no samples accumulated in Accuracy metric")
        return self.value / self.weight


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, *args):
        for m, a in zip(self._metrics, args):
            m.update(*a)

    def eval(self):
        return [m.eval() for m in self._metrics]


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, distances, seq_num):
        self.total += float(np.sum(distances))
        self.count += int(seq_num)

    def eval(self):
        return self.total / max(self.count, 1)


class Auc(MetricBase):
    """Host-side streaming AUC from prediction/label batches."""

    def __init__(self, name=None, num_thresholds=4095):
        super().__init__(name)
        self._n = num_thresholds
        self.reset()

    def reset(self):
        self.stat_pos = np.zeros(self._n + 1)
        self.stat_neg = np.zeros(self._n + 1)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        p1 = preds[:, 1] if preds.ndim == 2 and preds.shape[1] == 2 else (
            preds.reshape(-1))
        bucket = np.clip((p1 * self._n).astype(int), 0, self._n)
        for b, l in zip(bucket, labels):
            if l > 0:
                self.stat_pos[b] += 1
            else:
                self.stat_neg[b] += 1

    def eval(self):
        tp = np.cumsum(self.stat_pos[::-1])[::-1]
        fp = np.cumsum(self.stat_neg[::-1])[::-1]
        tot_pos, tot_neg = tp[0], fp[0]
        if tot_pos * tot_neg == 0:
            return 0.0
        tpn = np.append(tp[1:], 0.0)
        fpn = np.append(fp[1:], 0.0)
        area = np.sum((fp - fpn) * (tp + tpn) / 2.0)
        return float(area / (tot_pos * tot_neg))


class DetectionMAP(MetricBase):
    """11-point / integral mAP over accumulated detections."""

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, ap_version="integral"):
        super().__init__(name)
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.reset()

    def reset(self):
        # per-class: list of (score, tp) + gt count
        self._dets = {}
        self._gts = {}

    def update(self, detections, gt_boxes, gt_labels):
        """detections: (M, 6) [cls, score, x1, y1, x2, y2];
        gt_boxes: (G, 4); gt_labels: (G,)."""
        detections = np.asarray(detections)
        gt_boxes = np.asarray(gt_boxes)
        gt_labels = np.asarray(gt_labels).reshape(-1)
        matched = set()
        for g in gt_labels:
            self._gts[int(g)] = self._gts.get(int(g), 0) + 1
        order = np.argsort(-detections[:, 1])
        for i in order:
            cls, score = int(detections[i, 0]), detections[i, 1]
            if score < 0:
                continue
            box = detections[i, 2:6]
            best_iou, best_j = 0.0, -1
            for j in range(len(gt_boxes)):
                if int(gt_labels[j]) != cls or j in matched:
                    continue
                iou = _iou(box, gt_boxes[j])
                if iou > best_iou:
                    best_iou, best_j = iou, j
            tp = best_iou >= self.overlap_threshold and best_j >= 0
            if tp:
                matched.add(best_j)
            self._dets.setdefault(cls, []).append((float(score), tp))

    def eval(self):
        aps = []
        for cls, dets in self._dets.items():
            npos = self._gts.get(cls, 0)
            if npos == 0:
                continue
            dets = sorted(dets, key=lambda d: -d[0])
            tps = np.cumsum([d[1] for d in dets])
            fps = np.cumsum([not d[1] for d in dets])
            rec = tps / npos
            prec = tps / np.maximum(tps + fps, 1e-12)
            if self.ap_version == "11point":
                ap = np.mean([prec[rec >= t].max() if (rec >= t).any()
                              else 0.0 for t in np.linspace(0, 1, 11)])
            else:
                mrec = np.concatenate([[0], rec, [1]])
                mpre = np.concatenate([[0], prec, [0]])
                for k in range(len(mpre) - 2, -1, -1):
                    mpre[k] = max(mpre[k], mpre[k + 1])
                idx = np.where(mrec[1:] != mrec[:-1])[0]
                ap = np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1])
            aps.append(ap)
        return float(np.mean(aps)) if aps else 0.0


def _iou(a, b):
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return inter / max(ua, 1e-12)
