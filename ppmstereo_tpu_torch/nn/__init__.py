"""Building blocks as nn.Modules (counterpart of ppmstereo_tpu/nn)."""
