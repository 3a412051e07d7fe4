"""Temporal-FFT flow head on (B, T, H, W, C) videos (counterpart of
ppmstereo_tpu/nn/fft_head.py). No model calls it.

The clip's feature spectrum along the frame axis is modulated by a learned,
input-conditioned complex filter, mixed across channels by a complex linear
layer, normalised, scaled by `alpha1` and brought back by the inverse FFT;
the magnitude of the result is decoded to a 2-channel delta flow. The FFTs
run along the frame axis with norm="ortho" in f32 / complex64 whatever the
module dtype.

Complex weights are float parameters with a trailing axis of 2 (real,
imaginary), as the JAX package stores them, so the weight carry maps them
one to one.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ppmstereo_tpu_torch.nn.common import Conv


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(x[..., 0], x[..., 1])


class FFTLinear(nn.Module):
    """Complex channel-mixing linear over the spectrum: `complex_weight`
    (out, in, 2), complex (B, T, H, W, in) -> (B, T, H, W, out)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.complex_weight = nn.Parameter(torch.randn(features, in_features, 2) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("oc,bthwc->bthwo", _as_complex(self.complex_weight.float()), x)


class FFTBatchNorm(nn.Module):
    """Normalisation of a complex (B, T, H, W, C) spectrum on its
    interleaved real / imaginary view: each channel of each clip over (T, H,
    W, re/im), eps 1e-5, no affine and no running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.stack([x.real, x.imag], dim=-2)  # (B, T, H, W, 2, C)
        var, mean = torch.var_mean(stacked, dim=(1, 2, 3, 4), keepdim=True, correction=0)
        normed = (stacked - mean) / torch.sqrt(var + 1e-5)
        return torch.complex(normed[..., 0, :], normed[..., 1, :])


class TemporalFFT(nn.Module):
    """Spectrum modulation: (B, T, H, W, C) real -> x + iFFT(alpha * norm(
    linear(FFT(x) * filter(x)))), complex64 (the caller takes its
    magnitude). The filter is two bias-free 3x3x3 convs with a relu between,
    2C channels read as C complex ones."""

    def __init__(self, input_dim: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = input_dim
        self.filter_g1 = Conv(c, 2 * c, (3, 3, 3), use_bias=False, dtype=dtype)
        self.filter_g2 = Conv(2 * c, 2 * c, (3, 3, 3), use_bias=False, dtype=dtype)
        self.linear1 = FFTLinear(c, c)
        self.norm1 = FFTBatchNorm()
        self.alpha1 = nn.Parameter(torch.zeros(1, 1, 1, 1, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        x32 = x.float()
        x_t = torch.fft.fft(x32, dim=1, norm="ortho")
        g = self.filter_g2(F.relu(self.filter_g1(x)))
        filt = _as_complex(g.float().reshape(b, t, h, w, c, 2))
        y = self.norm1(self.linear1(x_t * filt))
        out = torch.fft.ifft(y * self.alpha1.float(), n=t, dim=1, norm="ortho")
        return x32 + out


class FlowHead3DFFT(nn.Module):
    """FFT-modulated 3-D flow head: |TemporalFFT(x)| in x's dtype, a
    bias-free (1, 5, 5) conv to `hidden_dim`, relu, and a bias-free (1, 3, 3)
    conv to the 2-channel flow."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.temporal = TemporalFFT(input_dim, dtype)
        self.conv1 = Conv(input_dim, hidden_dim, (1, 5, 5), use_bias=False, dtype=dtype)
        self.conv2 = Conv(hidden_dim, 2, (1, 3, 3), use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_t = self.temporal(x).abs().to(x.dtype)
        return self.conv2(F.relu(self.conv1(x_t)))
