"""Scene tiling and stitching, on-device augmentation, synthetic batches."""
