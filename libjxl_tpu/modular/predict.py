"""Modular predictors, property computation, weighted predictor.

Mirrors modular/encoding/context_predict.h: 14 decode-side predictors
(options.h:21-40), the self-correcting Weighted predictor (state machine,
context_predict.h:34-210), and the per-pixel property vector.
"""

from __future__ import annotations

import numpy as np

from ..io.fields import Bundle

# Predictor ids (modular/options.h:21-40)
(P_ZERO, P_LEFT, P_TOP, P_AVG0, P_SELECT, P_GRADIENT, P_WEIGHTED, P_TOPRIGHT,
 P_TOPLEFT, P_LEFTLEFT, P_AVG1, P_AVG2, P_AVG3, P_AVG4) = range(14)
NUM_PREDICTORS = 14

NUM_STATIC_PROPERTIES = 2  # channel, group id
# kNumNonrefProperties = 2 static + 13 local + 1 WP (context_predict.h:349)
NUM_NONREF_PROPERTIES = NUM_STATIC_PROPERTIES + 13 + 1
WP_PROP = NUM_NONREF_PROPERTIES - 1
GRADIENT_PROP = 9
EXTRA_PROPS_PER_CHANNEL = 4


def clamped_gradient(n, w, l):
    """ClampedGradient (context_predict.h:355-372); works on ints or arrays."""
    if isinstance(n, np.ndarray) or isinstance(w, np.ndarray):
        m = np.minimum(n, w)
        M = np.maximum(n, w)
        grad = (n.astype(np.int64) if isinstance(n, np.ndarray) else n) + w - l
        return np.where(l < m, M, np.where(l > M, m, grad))
    m = min(n, w)
    M = max(n, w)
    grad = n + w - l
    if l < m:
        return M
    if l > M:
        return m
    return grad


def select_predictor(a, b, c):
    p = a + b - c
    pa = abs(p - a)
    pb = abs(p - b)
    return a if pa < pb else b


class WeightedHeader(Bundle):
    """weighted::Header (context_predict.h:33-68)."""

    def visit_fields(self, v):
        if v.all_default(self):
            return
        for name, d in (("p1c", 16), ("p2c", 10), ("p3ca", 7), ("p3cb", 7),
                        ("p3cc", 7), ("p3cd", 0), ("p3ce", 0)):
            setattr(self, name, v.bits_val(getattr(self, name), 5, d))
        self.w = [v.bits_val(self.w[i], 4, d)
                  for i, d in enumerate((0xD, 0xC, 0xC, 0xC))]

    def set_default(self):
        self.all_default = True
        self.p1c, self.p2c = 16, 10
        self.p3ca = self.p3cb = self.p3cc = 7
        self.p3cd = self.p3ce = 0
        self.w = [0xD, 0xC, 0xC, 0xC]


_DIVLOOKUP = np.array([(1 << 24) // (i + 1) for i in range(64)], dtype=np.int64)
PRED_EXTRA_BITS = 3
PREDICTION_ROUND = ((1 << PRED_EXTRA_BITS) >> 1) - 1  # = 3
NUM_WP_PREDICTORS = 4


class WeightedState:
    """weighted::State (context_predict.h:70-210). Strictly sequential in
    raster order (error-history feedback) — this is the known vectorization
    obstacle (SURVEY.md section 3.4); the vectorized/native paths only use
    it when the tree demands it."""

    def __init__(self, header: WeightedHeader, xsize: int, ysize: int):
        self.header = header
        self.xsize = xsize
        stride = xsize + 2
        self.pred_errors = [np.zeros(2 * stride, dtype=np.int64)
                            for _ in range(NUM_WP_PREDICTORS)]
        self.error = np.zeros(2 * stride, dtype=np.int64)
        self.prediction = [0] * NUM_WP_PREDICTORS
        self.pred = 0

    @staticmethod
    def _add_bits(x):
        return x << PRED_EXTRA_BITS

    def _error_weight(self, x, maxweight):
        shift = max((int(x) + 1).bit_length() - 1 - 5, 0)
        return 4 + ((maxweight * int(_DIVLOOKUP[x >> shift])) >> shift)

    def predict(self, x, y, xsize, n, w, ne, nw, nn,
                compute_property: bool = False):
        """Returns (prediction, max_error_property or None)."""
        stride = xsize + 2
        cur_row = 0 if (y & 1) else stride
        prev_row = stride if (y & 1) else 0
        pos_n = prev_row + x
        pos_ne = pos_n + 1 if x < xsize - 1 else pos_n
        pos_nw = pos_n - 1 if x > 0 else pos_n
        weights = []
        for i in range(NUM_WP_PREDICTORS):
            werr = (int(self.pred_errors[i][pos_n])
                    + int(self.pred_errors[i][pos_ne])
                    + int(self.pred_errors[i][pos_nw]))
            weights.append(self._error_weight(werr, self.header.w[i]))
        n8, w8 = self._add_bits(n), self._add_bits(w)
        ne8, nw8, nn8 = (self._add_bits(ne), self._add_bits(nw),
                         self._add_bits(nn))
        te_w = 0 if x == 0 else int(self.error[cur_row + x - 1])
        te_n = int(self.error[pos_n])
        te_nw = int(self.error[pos_nw])
        te_ne = int(self.error[pos_ne])
        sum_wn = te_n + te_w
        prop = None
        if compute_property:
            p = te_w
            for cand in (te_n, te_nw, te_ne):
                if abs(cand) > abs(p):
                    p = cand
            prop = p
        h = self.header
        self.prediction[0] = w8 + ne8 - n8
        self.prediction[1] = n8 - (((sum_wn + te_ne) * h.p1c) >> 5)
        self.prediction[2] = w8 - (((sum_wn + te_nw) * h.p2c) >> 5)
        self.prediction[3] = n8 - ((te_nw * h.p3ca + te_n * h.p3cb
                                    + te_ne * h.p3cc + (nn8 - n8) * h.p3cd
                                    + (nw8 - w8) * h.p3ce) >> 5)
        # WeightedAverage (context_predict.h:111-133)
        weight_sum = sum(weights)
        log_weight = weight_sum.bit_length() - 1  # >= 4
        ws = [wt >> (log_weight - 4) for wt in weights]
        weight_sum = sum(ws)
        s = (weight_sum >> 1) - 1
        for i in range(NUM_WP_PREDICTORS):
            s += self.prediction[i] * ws[i]
        self.pred = (s * int(_DIVLOOKUP[weight_sum - 1])) >> 24
        if ((te_n ^ te_w) | (te_n ^ te_nw)) > 0:
            return (self.pred + PREDICTION_ROUND) >> PRED_EXTRA_BITS, prop
        mx = max(w8, ne8, n8)
        mn = min(w8, ne8, n8)
        self.pred = max(mn, min(mx, self.pred))
        return (self.pred + PREDICTION_ROUND) >> PRED_EXTRA_BITS, prop

    def update_errors(self, val, x, y, xsize):
        stride = xsize + 2
        cur_row = 0 if (y & 1) else stride
        prev_row = stride if (y & 1) else 0
        val8 = self._add_bits(val)
        self.error[cur_row + x] = self.pred - val8
        for i in range(NUM_WP_PREDICTORS):
            err = (abs(self.prediction[i] - val8) + PREDICTION_ROUND) \
                >> PRED_EXTRA_BITS
            self.pred_errors[i][cur_row + x] = err
            self.pred_errors[i][prev_row + x + 1] += err


def predict_one(p, left, top, toptop, topleft, topright, leftleft,
                toprightright, wp_pred):
    """PredictOne (context_predict.h:440-486). // is floor but reference uses
    C++ / (truncation); mirror with int() division toward zero."""
    if p == P_ZERO:
        return 0
    if p == P_LEFT:
        return left
    if p == P_TOP:
        return top
    if p == P_SELECT:
        return select_predictor(left, top, topleft)
    if p == P_WEIGHTED:
        return wp_pred
    if p == P_GRADIENT:
        return clamped_gradient(left, top, topleft)
    if p == P_TOPLEFT:
        return topleft
    if p == P_TOPRIGHT:
        return topright
    if p == P_LEFTLEFT:
        return leftleft
    if p == P_AVG0:
        return _cdiv2(left + top)
    if p == P_AVG1:
        return _cdiv2(left + topleft)
    if p == P_AVG2:
        return _cdiv2(topleft + top)
    if p == P_AVG3:
        return _cdiv2(top + topright)
    if p == P_AVG4:
        return _cdiv(6 * top - 2 * toptop + 7 * left + leftleft
                     + toprightright + 3 * topright + 8, 16)
    return 0


def _cdiv2(v):
    # C++ integer division truncates toward zero
    return -((-v) // 2) if v < 0 else v // 2


def _cdiv(v, d):
    return -((-v) // d) if v < 0 else v // d


def neighbors(plane: np.ndarray, x: int, y: int, w: int):
    """Edge-case-handled neighbor fetch (context_predict.h:493-500)."""
    row = plane[y]
    prow = plane[y - 1] if y else None
    left = int(row[x - 1]) if x else (int(prow[x]) if y else 0)
    top = int(prow[x]) if y else left
    topleft = int(prow[x - 1]) if (x and y) else left
    topright = int(prow[x + 1]) if (x + 1 < w and y) else top
    leftleft = int(row[x - 2]) if x > 1 else left
    toptop = int(plane[y - 2][x]) if y > 1 else top
    toprightright = int(prow[x + 2]) if (x + 2 < w and y) else topright
    return left, top, topleft, topright, leftleft, toptop, toprightright


def compute_properties(props, x, y, w, left, top, topleft, topright,
                       leftleft, toptop):
    """Fills props[3..13] (context_predict.h:506-527); props[0..2] are
    static_props + y set by init_props_row."""
    props[3] = x
    props[4] = top if top > 0 else -top
    props[5] = left if left > 0 else -left
    props[6] = top
    props[7] = left
    # local gradient: left - (previous value of props[9]=W+N-NW of this x)
    props[8] = left - props[9]
    props[9] = left + top - topleft
    props[10] = left - topleft
    props[11] = topleft - top
    props[12] = top - topright
    props[13] = top - toptop
    props[14] = left - leftleft
