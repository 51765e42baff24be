"""Port of ``repro.launch``: device meshes over ``torch.distributed``
(``mesh.py``), the serving launcher (``serve.py``), the training launcher
(``train.py``) and the dry-run (``dryrun.py``) of every cell on the
production meshes: train cells (the SSM models' too: the selective scan and
its backward are one op a call), prefill and decode cells."""
