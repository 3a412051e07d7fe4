"""Video-Depth-Anything: DINOv2, the DPT-temporal head and its motion
modules (counterpart of ppmstereo_tpu/nn/vda)."""
