"""Port of ``repro.launch``: device meshes over ``torch.distributed``
(``mesh.py``), the serving launcher (``serve.py``) and the training
launcher (``train.py``).  The dry-run comes after sharded execution and the
roofline twin (ROADMAP)."""
