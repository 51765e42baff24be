#!/usr/bin/env python3
"""The image retriever's masked-rerank traffic, on one NVIDIA GPU: how many
rows each call of ``l2_rerank_masked`` asks for, and where they fall.

Builds PaliGemma-3B at full width with ``chip_smoke.py``'s seeded weights,
runs ``chip_smoke.retrieval_phase`` (8,192 images embedded, indexed by
``EmbeddingRetriever(metric="angular")``, 1,024 queries searched 256 at a
time, then the capture batch whose RETR_CAPTURE_CALL-th call the smoke's
``masked_retriever_*`` entry times) and watches every rerank call on the way.
Prints, over every call before the capture batch (the index build's and
the searches'), over the capture batch and of the smoke's captured call:
the rows asked for a call, the queries that ask, the rows of one asking
query and of one 32-candidate window that asks.  With ``--save FILE`` it writes the
capture batch's every call (queries, ids, acc, mask) and the base for
``scripts/kernel_variants.py --round FILE``, which times the wide rerank's
variants on them.  Run from the repository root:

    python3 scripts/retriever_round.py [--save results/retriever_round.pt]
                                       [--out results/retriever_round.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WINDOW = 32          # candidates of one window, as the profile counts them


def _quantiles(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"n": 0}
    at = lambda f: xs[min(len(xs) - 1, int(f * len(xs)))]  # noqa: E731
    return {"n": len(xs), "min": xs[0], "median": at(0.5), "p90": at(0.9),
            "max": xs[-1], "mean": sum(xs) / len(xs)}


def profile(masks) -> dict:
    """Row counts of a list of (Q, K) bool masks (CPU tensors)."""
    per_call, queries, per_query, per_window = [], [], [], []
    for m in masks:
        rows = m.sum(1)
        per_call.append(int(rows.sum()))
        queries.append(int((rows > 0).sum()))
        per_query += [int(r) for r in rows[rows > 0]]
        k = m.shape[1]
        for w0 in range(0, k, WINDOW):
            wr = m[:, w0 : w0 + WINDOW].sum(1)
            per_window += [int(r) for r in wr[wr > 0]]
    return {"calls": len(masks),
            "calls_asking": sum(1 for r in per_call if r),
            "rows_a_call": _quantiles(per_call),
            "queries_asking_a_call": _quantiles(queries),
            "rows_an_asking_query": _quantiles(per_query),
            "rows_an_asking_window": _quantiles(per_window)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", default=None)
    ap.add_argument("--out", default="results/retriever_round.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("retriever_round: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import loader, ops
    from repro_torch.models.model import build_model

    print(cs._card_line(), flush=True)
    loader.build_all()
    dev = torch.device("cuda")
    model = build_model(get_config(cs.SERVE_ARCH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            args.seed))
    real = ops.l2_rerank_masked
    searched, batch = [], []

    def watch(queries, ids, base, acc, mask, metric="l2"):
        # the smoke installs its spy (which calls this) for the capture
        # batch only: there the module no longer holds ``watch``
        if ops.l2_rerank_masked is watch:
            searched.append(mask.cpu())
        else:
            batch.append((queries, ids.clone(), base, acc.clone(),
                          mask.clone(), metric))
        return real(queries, ids, base, acc, mask, metric)

    ops.l2_rerank_masked = watch
    try:
        rec, captured = cs.retrieval_phase(torch, dev, model, args.seed,
                                           print)
    finally:
        ops.l2_rerank_masked = real
    cap = captured["l2_rerank_masked"]
    at = next(i for i, c in enumerate(batch) if torch.equal(c[4], cap[4])
              and torch.equal(c[1], cap[1]))
    result = {"card": cs._card_line(),
              "recall_at_10": rec["recall_at_10"],
              "shape": {"Q": cap[1].shape[0], "K": cap[1].shape[1],
                        "N": cap[2].shape[0], "D": cap[2].shape[1]},
              "searches": profile(searched),
              "capture_batch": profile([c[4].cpu() for c in batch]),
              "captured_call": {"index": at,
                                **profile([cap[4].cpu()]),
                                "rows_by_query": {
                                    int(q): int(r) for q, r in enumerate(
                                        cap[4].sum(1).tolist()) if r}}}
    print(json.dumps(result), flush=True)
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    if args.save:
        qs = {}
        for c in batch:
            qs.setdefault(c[0].data_ptr(), c[0])
        keys = list(qs)
        save = Path(args.save)
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"base": cap[2], "queries": [qs[k] for k in keys],
                    "calls": [(keys.index(c[0].data_ptr()), c[1], c[3], c[4])
                              for c in batch],
                    "metric": cap[5], "captured": at}, save)
        print(f"saved {len(batch)} calls to {save}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
