"""Port of ``repro.launch``: device meshes over ``torch.distributed``
(``mesh.py``) and the serving launcher (``serve.py``).  The training and
dry-run launchers serve the LM stack and come with it (ROADMAP item 16)."""
