"""PyTorch/CUDA port of vit_fpga_tpu for NVIDIA Hopper (H100)."""

__version__ = "0.1.0"
