"""Port of ``repro.kernels``: the four Pallas TPU kernels as hand-written CUDA
kernels for Hopper (``csrc/``), each with its plain PyTorch version; and the
SSM blocks' selective scan (``selective_scan``) and its backward, hand kernels
with no Pallas counterpart."""
