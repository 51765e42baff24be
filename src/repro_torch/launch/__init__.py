"""Port of ``repro.launch``: device meshes over ``torch.distributed``
(``mesh.py``) and the serving launcher (``serve.py``).  The training and
dry-run launchers serve the LM stack's training and come with it (ROADMAP
item 16b)."""
