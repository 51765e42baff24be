"""Port of ``repro.roofline``: the roofline terms of a traced step
(``analysis.py``) from a dispatch trace's per-device counts
(``trace_count.py``)."""
