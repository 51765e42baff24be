"""Port of ``repro.launch``: device meshes over ``torch.distributed``
(``mesh.py``), the serving launcher (``serve.py``), the training launcher
(``train.py``) and the dry-run of the train cells on the production meshes
(``dryrun.py``; its prefill and decode cells wait for sharded serving,
ROADMAP)."""
