"""insarseg_torch — the PyTorch / CUDA port of ``insarseg`` for NVIDIA Hopper.

The JAX package ``insarseg`` is the reference; this package mirrors its
module paths so each counterpart is easy to find, and is held to it by the
parity tests (``tests/test_torch_*.py``). It imports ``torch`` and numpy
only — never ``jax``, ``flax`` or anything of ``insarseg``.

Conventions:

- public functions take and return NHWC tensors, as the JAX package does
  (images ``(B, H, W, C)``, logits ``(B, H, W, nc)``); the ``nn.Module``
  UNet keeps the reference's NCHW idiom and its state_dict names;
- entry points take ``device=None``, which means ``cuda``; without a card
  they raise unless the caller passes ``device="cpu"``;
- the int8 engine's hand-written CUDA kernels (``insarseg_torch.kernels``)
  run on CUDA tensors; on CPU tensors their plain PyTorch versions run.
"""

from insarseg_torch.device import resolve_device

__all__ = ["resolve_device"]
