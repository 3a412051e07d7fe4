"""PPMStereo in PyTorch and CUDA: the port of `ppmstereo_tpu` to an NVIDIA
H100 (Hopper, sm_90a).

The JAX package stays the reference; this package imports nothing of it
(and nothing of JAX). Module paths mirror the JAX package:

  ops/      plain tensor functions (geometry, padding, upsampling, correlation)
  kernels/  hand-written CUDA kernels, their plain PyTorch versions, the nvcc build
  csrc/     the kernels' CUDA C++ sources
  nn/       building blocks as nn.Modules (encoders, attention, GRU, heads;
            vda/: the Video-Depth-Anything backbone)
  models/   the PPMStereo graph (with and without the VDA backbone), the
            baselines (DynamicStereo, RAFT-Stereo, BiDAStereo with its RAFT,
            StereoAnyVideo), the sliding-window predictor and its window
            modes, the zoo
  data/     file formats (with a PNG codec), the evaluation readers, the
            synthetic training set, the augmentor, the batch loader
  evaluation/  EPE/TEPE metrics, the sequence evaluator, visualisations
  train/    loss, optimiser, train step, checkpoints, the training loop
  cli/      command-line entry points (train, evaluate, demo, import_torch)
  configs/  the evaluation presets (YAML)
  utils/    device selection, precision settings, the weight carry and
            export, the reference checkpoints' import and its mapping
            tables, initialisation, configs and overrides, metrics logging

Public functions keep the JAX layouts: (B, T, H, W, C) for model inputs and
outputs, (N, 2, H, W, 3) in [0, 255] for a predictor's stereo video.
Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
