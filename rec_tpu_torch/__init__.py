"""rec_tpu_torch — the PyTorch/CUDA port of rec_tpu for NVIDIA Hopper.

The lossless main path of ``rec_tpu`` (flagship RVAE, beam-search coder,
``.rec`` container with the true-lossless residual) and its lossy regime
(the 1- and 2-level Ballé VAEs) rewritten in eager PyTorch, with the
whole-partition beam-search kernel written by hand in CUDA C++ for
``sm_90a`` (``csrc/mega_beam.cu``).  Module names mirror ``rec_tpu``
so each counterpart is easy to find.  Entry points run on the GPU unless the
caller asks for the CPU (``device="cpu"``); see ``device.py``.
"""

__version__ = "0.1.0"
