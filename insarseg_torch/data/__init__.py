"""The data path: the VOC reader and batch loader, the native host
kernels and prefetching, scene tiling and stitching, on-device
augmentation, synthetic data."""
