"""Model graphs, the sliding-window predictor and the zoo (counterpart of ppmstereo_tpu/models)."""
