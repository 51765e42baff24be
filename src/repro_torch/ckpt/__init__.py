"""Port of ``repro.ckpt``: checkpoints in the reference's layout on disk
(``checkpoint.py``)."""
