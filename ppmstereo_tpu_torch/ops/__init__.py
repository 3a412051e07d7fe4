"""Plain tensor functions, channels-last (counterpart of ppmstereo_tpu/ops)."""
