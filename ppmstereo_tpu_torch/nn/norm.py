"""Normalisation layers on channels-last tensors (counterpart of
ppmstereo_tpu/nn/norm.py). Statistics are taken in f32 whatever the
compute dtype; the result is cast back to the input's dtype."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class InstanceNorm(nn.Module):
    """nn.InstanceNorm2d(affine=False) semantics on (..., H, W, C): each
    channel normalised over its spatial extent, eps 1e-5, f32 statistics."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        axes = (x.dim() - 3, x.dim() - 2)
        var, mean = torch.var_mean(x32, dim=axes, keepdim=True, correction=0)
        return ((x32 - mean) / torch.sqrt(var + self.epsilon)).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with a learned scale (`weight`, flax
    `scale`) and bias; f32 statistics, output in the input's dtype (the JAX
    modules pass `dtype=x.dtype`)."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.epsilon)
        return y.to(x.dtype)
