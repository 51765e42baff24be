"""Port of ``repro.distributed``: the logical-axis sharding rules
(``sharding.py``) and the fault-tolerant loop (``fault.py``)."""
