"""Port of ``repro.train``: the step-seeded synthetic data (``data.py``),
AdamW (``optimizer.py``) and the microbatched, data-parallel train step
(``loop.py``)."""
