"""The model zoo joined to the search (``examples/image_retrieval.py``):
``EmbeddingRetriever`` over clustered embeddings, the port against the
reference on the CPU.

    PYTHONPATH=src:tests python tests/test_torch_retrieval.py

prints both packages' recall@10 at 64 and 32 points a class."""
import json

import numpy as np
import pytest


def retrieve(classes: int, n: int = 4096, d: int = 128) -> dict:
    """``EmbeddingRetriever`` (angular, R = 32) of each package over ``n``
    points in ``classes`` tight clusters (centres N(0, 1), noise 0.3), each
    building its own index; 256 fresh queries: the ids and recall@10
    against the exact angular kNN."""
    from repro.core.dataset import exact_knn
    from repro.serve.retrieval import EmbeddingRetriever as RefRetriever
    from repro_torch.serve.retrieval import EmbeddingRetriever

    rng = np.random.default_rng(5)
    centres = rng.standard_normal((classes, d)).astype(np.float32)
    labels = np.repeat(np.arange(classes), n // classes)
    q_labels = rng.integers(0, classes, 256)
    base = centres[labels] + 0.3 * rng.standard_normal((n, d)).astype(
        np.float32)
    queries = centres[q_labels] + 0.3 * rng.standard_normal(
        (256, d)).astype(np.float32)
    want = np.asarray(RefRetriever(base, metric="angular").query(
        queries, k=10)[0])
    got = EmbeddingRetriever(base, metric="angular", device="cpu").query(
        queries, k=10)[0]
    gt = np.asarray(exact_knn(queries, base, 10, "angular"))

    def recall(ids):
        return float(np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(ids, gt)]))

    return {"got": got, "want": want, "recall": recall(got),
            "ref_recall": recall(want)}


@pytest.mark.parametrize("classes", [64, 128])
def test_retriever_over_class_clusters_matches_reference(classes):
    """Port and reference: the same ids as sets in >= 99% of rows (the
    build's bar is recall, PERF.md) and the same recall@10 to 0.005.
    With 64 points a class the build list (2R = 64) holds only a point's
    own class, the graph falls into cliques and recall@10 collapses in both;
    with 32 a class it does not.  The model phase of ``chip_smoke.py``
    takes its image classes 32 at a time for this reason (PERF.md)."""
    r = retrieve(classes)
    same = np.mean([set(a) == set(b) for a, b in zip(r["got"], r["want"])])
    assert same >= 0.99, same
    assert abs(r["recall"] - r["ref_recall"]) <= 0.005, r
    assert (r["recall"] < 0.5) == (4096 // classes == 64), r["recall"]


if __name__ == "__main__":
    for classes in (64, 128):
        r = retrieve(classes)
        print(json.dumps({"points_a_class": 4096 // classes,
                          "recall_at_10": r["recall"],
                          "reference_recall_at_10": r["ref_recall"]}))
