"""Per-round convergence telemetry — the learned-early-termination dataset;
copy of ``src/repro/obs/convergence.py``.  One change: ``record_lanes``
reads the (selected) lane tensors to the host in one copy per call.

The round-step kernels (``core.graph_search_step``) already carry everything
a per-query termination predictor needs, per lane per round: the sorted
candidate-list distances (top-k gap trajectory), the top-k repetition
counter ``stable`` the fixed rule thresholds on, the adaptive list length
``t`` and the unevaluated frontier.  This module captures that trajectory
into a bounded ring buffer of per-(lane, round) records plus a
rounds-to-quiesce label per lane — exported as ``.npz``/JSONL, it IS the
training set the ROADMAP's "per-query adaptive compute" item trains on::

    log = ConvergenceLog(capacity=1 << 16)
    sess = searcher.planner.round_session(searcher.plan(req))
    res, rounds = trace_session(sess, queries, log)     # off-line collection
    log.save_npz("results/convergence_log.npz")
    X, y, names = ConvergenceLog.load_npz(
        "results/convergence_log.npz").dataset()

or live, from the continuous engine (``Observability.on(convergence=True)``):
every scheduler tick appends one record per occupied lane and every retire
stamps the lane's label, so production traffic grows the same dataset.

Record fields (one row per lane per round):

  ``qid``       lane identity (engine: the request id; off-line: sequential)
  ``round``     rounds executed so far (1-based after the first step)
  ``d_top1``    best candidate distance
  ``gap_topk``  d_k - d_1 over the candidate list (inf while the list is
                shorter than k)
  ``gap_rel``   gap_topk / max(|d_top1|, eps)
  ``stable``    consecutive rounds with an unchanged top-k (the fixed
                rule terminates at ``repetition_rate``)
  ``t_size``    adaptive candidate-list length T this round
  ``frontier``  valid-but-unevaluated candidates (expansion fuel left)
  ``churn``     top-k ids replaced since the lane's previous record
  ``done``      lane quiesced on this round

The ring drops the OLDEST records on overflow (``dropped`` counts them);
labels are kept for every finalized lane regardless, so late records always
find their label."""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

#: feature columns, in `dataset()` order; qid/done ride along as metadata
FEATURES = ("round", "d_top1", "gap_topk", "gap_rel", "stable", "t_size",
            "frontier", "churn")
FIELDS = ("qid",) + FEATURES + ("done",)

_DTYPES = {"qid": np.int64, "round": np.int32, "stable": np.int32,
           "t_size": np.int32, "frontier": np.int32, "churn": np.int32,
           "done": np.bool_, "d_top1": np.float32, "gap_topk": np.float32,
           "gap_rel": np.float32}


def _host_lanes(lanes, select) -> tuple:
    """(dists f64, ids, stable, t, rounds, done, evaluated) host arrays of
    the selected lane rows, read in ONE copy: the rows are gathered where
    the state lives, packed into one float64 tensor (every field is exact
    in float64: int32 ids and counters, f32 distances, bools) and moved
    with one ``.cpu()``."""
    import torch

    fields = (lanes.dists, lanes.ids, lanes.evaluated, lanes.stable, lanes.t,
              lanes.rounds, lanes.done)
    if select is not None:
        rows = torch.as_tensor(np.asarray(select, np.int64),
                               device=lanes.ids.device)
        fields = tuple(f.index_select(0, rows) for f in fields)
    w = lanes.ids.shape[1]
    packed = torch.cat([f.reshape(f.shape[0], -1).to(torch.float64)
                        for f in fields], 1).cpu().numpy()
    dists, ids, ev = (packed[:, :w], packed[:, w:2 * w],
                      packed[:, 2 * w:3 * w])
    stable, t, rounds, done = packed[:, 3 * w:].T
    return (dists, ids.astype(np.int64), stable.astype(np.int64),
            t.astype(np.int64), rounds.astype(np.int64), done != 0, ev != 0)


class ConvergenceLog:
    """Bounded ring of per-round traversal records + rounds-to-quiesce
    labels.  Append via :meth:`record_lanes` (or a ``RoundSession``'s
    ``record_round``), stamp labels via :meth:`finalize_lane`."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity <= 0:
            raise ValueError("ConvergenceLog capacity must be positive")
        self.capacity = int(capacity)
        self._buf = {f: np.zeros(self.capacity, _DTYPES[f]) for f in FIELDS}
        self._n = 0                               # records ever appended
        self.labels: Dict[int, int] = {}          # qid -> rounds to quiesce
        self._prev_topk: Dict[int, np.ndarray] = {}
        self._next_qid = 0

    # ------------------------------------------------------------ recording
    def alloc_qids(self, n: int) -> np.ndarray:
        """Fresh lane ids for an off-line collection batch (the engine uses
        request ids instead — both are unique within one log)."""
        out = np.arange(self._next_qid, self._next_qid + n, dtype=np.int64)
        self._next_qid += n
        return out

    def record_lanes(self, qids: Sequence[int], state, k: int,
                     select: Optional[Sequence[int]] = None) -> None:
        """Append one record per lane from a post-step ``SearchState``.
        ``select`` picks lane rows (the engine passes its occupied slots);
        ``qids`` aligns with the selected rows."""
        lanes = getattr(state, "lanes", state)
        dists, ids, stable, t, rounds, done, evaluated = _host_lanes(
            lanes, select)
        for row in range(len(qids)):
            qid = int(qids[row])
            d = dists[row]
            valid = np.isfinite(d)
            d1 = float(d[0]) if valid[0] else np.inf
            dk = float(d[k - 1]) if k <= d.shape[0] and valid[
                min(k - 1, d.shape[0] - 1)] else np.inf
            gap = dk - d1
            gap_rel = gap / max(abs(d1), 1e-12) if np.isfinite(gap) \
                else np.inf
            topk = ids[row, :k][valid[:k]]
            prev = self._prev_topk.get(qid)
            if prev is None:
                churn = int(topk.size)
            else:
                churn = int(topk.size
                            - len(set(topk.tolist()) & set(prev.tolist())))
            self._prev_topk[qid] = np.array(topk)
            i = self._n % self.capacity
            b = self._buf
            b["qid"][i] = qid
            b["round"][i] = int(rounds[row])
            b["d_top1"][i] = d1
            b["gap_topk"][i] = gap
            b["gap_rel"][i] = gap_rel
            b["stable"][i] = int(stable[row])
            b["t_size"][i] = int(t[row])
            b["frontier"][i] = int((valid & ~evaluated[row]).sum())
            b["churn"][i] = churn
            b["done"][i] = bool(done[row])
            self._n += 1

    def finalize_lane(self, qid: int, rounds: int) -> None:
        """Stamp a lane's rounds-to-quiesce label (engine retire path)."""
        self.labels[int(qid)] = int(rounds)
        self._prev_topk.pop(int(qid), None)

    def finalize_lanes(self, qids: Sequence[int],
                       rounds: Sequence[int]) -> None:
        for q, r in zip(qids, rounds):
            self.finalize_lane(int(q), int(r))

    # ----------------------------------------------------------- inspection
    @property
    def count(self) -> int:
        return min(self._n, self.capacity)

    @property
    def dropped(self) -> int:
        return max(0, self._n - self.capacity)

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Retained records in chronological order, one array per field."""
        n = self.count
        if self._n <= self.capacity:
            return {f: self._buf[f][:n].copy() for f in FIELDS}
        i0 = self._n % self.capacity
        return {f: np.concatenate([self._buf[f][i0:], self._buf[f][:i0]])
                for f in FIELDS}

    def dataset(self) -> tuple[np.ndarray, np.ndarray, tuple]:
        """(X, y, feature_names): one row per retained record whose lane has
        a label; ``y`` is the lane's TOTAL rounds-to-quiesce (subtract the
        ``round`` column for remaining-rounds targets)."""
        recs = self.to_arrays()
        qid = recs["qid"]
        have = np.array([int(q) in self.labels for q in qid], bool)
        X = np.stack([recs[f].astype(np.float64) for f in FEATURES],
                     axis=1)[have]
        y = np.array([self.labels[int(q)] for q in qid[have]], np.int64)
        return X, y, FEATURES

    # -------------------------------------------------------------- export
    def save_npz(self, path: str) -> None:
        recs = self.to_arrays()
        lq = np.fromiter(self.labels.keys(), np.int64, len(self.labels))
        lr = np.fromiter(self.labels.values(), np.int64, len(self.labels))
        np.savez(path, label_qid=lq, label_rounds=lr,
                 capacity=np.int64(self.capacity),
                 dropped=np.int64(self.dropped), **recs)

    @classmethod
    def load_npz(cls, path: str) -> "ConvergenceLog":
        with np.load(path) as z:
            log = cls(capacity=int(z["capacity"]))
            n = len(z["qid"])
            for f in FIELDS:
                log._buf[f][:n] = z[f]
            log._n = n
            log.labels = {int(q): int(r) for q, r in
                          zip(z["label_qid"], z["label_rounds"])}
        if log.labels:
            log._next_qid = max(log.labels) + 1
        return log

    def export_jsonl(self, path: str) -> None:
        """One JSON object per record, then one ``label`` object per lane.
        Non-finite floats are emitted as nulls so any strict parser reads
        the file back."""
        recs = self.to_arrays()

        def _j(v):
            f = float(v)
            return f if np.isfinite(f) else None

        with open(path, "w") as fh:
            for i in range(self.count):
                row = {"type": "round"}
                for f in FIELDS:
                    v = recs[f][i]
                    row[f] = _j(v) if np.issubdtype(type(v), np.floating) \
                        else (bool(v) if f == "done" else int(v))
                fh.write(json.dumps(row) + "\n")
            for q, r in sorted(self.labels.items()):
                fh.write(json.dumps(
                    {"type": "label", "qid": q, "rounds": r}) + "\n")


def trace_session(session, queries, log: ConvergenceLog,
                  qids: Optional[np.ndarray] = None):
    """Step a ``plan.RoundSession`` to quiescence, recording every round of
    every lane into ``log`` and stamping rounds-to-quiesce labels — the
    off-line dataset collector (``serving_bench --quality`` ships its output
    as the CI artifact).  Returns ``(core_result, rounds)`` where ``rounds``
    is the (Q,) per-lane round count — by the round-step equivalence
    contract it matches what the whole-batch path reports in
    ``SearchStats.rounds``."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    if qids is None:
        qids = log.alloc_qids(q.shape[0])
    state = session.init(q)
    active = session.active(state)
    while active.any():
        state = session.step(state)
        sel = np.nonzero(active)[0]
        session.record_round(log, np.asarray(qids)[sel], state, select=sel)
        active = session.active(state)
    rounds = session.rounds(state)
    log.finalize_lanes(qids, rounds)
    return session.finalize(state), np.asarray(rounds)
