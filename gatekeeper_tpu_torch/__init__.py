"""gatekeeper_tpu_torch: the policy engine on PyTorch and CUDA.

The port of `gatekeeper_tpu` (JAX) to an NVIDIA Hopper card. The host
front half (Rego ingest, the Program IR, feature extraction, matching,
message materialization) is carried over module by module; the device
filter runs through hand-written kernels (kernels/, csrc/). Entry points
evaluate on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
