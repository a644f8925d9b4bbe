"""On-device preprocessing and augmentation of the train step (counterpart
of ``insarseg/data/augment.py``).

- :func:`normalize_u8`: uint8 tiles -> ``(x / 255 - mean) / std`` on the
  device, so the host ships bytes (a quarter of f32's transfer);
- :func:`random_dihedral`: a random D4 symmetry per sample (flip along W,
  flip along H, then transpose; the 8 rotations and reflections of a
  square tile), the same for the image and its mask. The flags come from
  an explicit ``torch.Generator`` or are passed in: jax.random's streams
  cannot be matched, so a parity test passes the JAX package's flags.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def normalize_u8(x: torch.Tensor, mean: float = 0.5, std: float = 0.5,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, C) -> ``x * (1 / (255 std)) - mean / std`` in f32,
    cast to ``dtype``, on ``x``'s device (the JAX package's arithmetic)."""
    a = 1.0 / (255.0 * std)
    b = -mean / std
    return (x.to(torch.float32) * a + b).to(dtype)


def random_dihedral(image: torch.Tensor, mask: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    flags: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random per-sample D4 symmetry applied to (image NHWC, mask NHW).
    ``flags``: (3, B) bool (flip along W, flip along H, transpose), or drawn
    from ``generator`` on its device, each with probability 1/2."""
    b, h, w = image.shape[:3]
    if h != w:
        raise ValueError(f"the dihedral transpose needs square tiles, got "
                         f"{h}x{w}")
    if flags is None:
        flags = torch.rand((3, b), generator=generator,
                           device=generator.device) < 0.5

    def apply(x):
        fh, fv, tp = (f.reshape((b,) + (1,) * (x.dim() - 1)) for f in flags)
        x = torch.where(fh, x.flip(2), x)
        x = torch.where(fv, x.flip(1), x)
        return torch.where(tp, x.transpose(1, 2), x)

    return apply(image), apply(mask)
