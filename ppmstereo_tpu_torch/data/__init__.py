"""Data: the synthetic training set, augmentation and the batch loader."""
