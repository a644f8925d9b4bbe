"""The data path: the VOC reader and batch loader, the native host
kernels and prefetching, scene tiling and stitching, streaming scenes
larger than memory, on-device augmentation, synthetic data."""

from insarseg_torch.data.serve import stream_scene_inference  # noqa: F401
