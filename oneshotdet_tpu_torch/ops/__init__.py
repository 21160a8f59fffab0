"""Ops: box coding, NMS and ROIAlign (plain versions and CUDA kernels)."""
