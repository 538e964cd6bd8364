"""mitsuba_tpu_torch: the PyTorch/CUDA port of mitsuba_tpu for NVIDIA Hopper.

The package mirrors ``mitsuba_tpu``'s layout module for module, so each ported
function sits at the same relative path as the JAX function it is tested
against. It imports ``torch`` and never ``jax`` or ``mitsuba_tpu``: host code it
needs (transforms, shapes, the scene builder) is copied, not shared.

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
__version__ = "0.1.0"
