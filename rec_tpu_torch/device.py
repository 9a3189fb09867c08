"""Device selection and the deterministic-numerics switch.

Every entry point of the port runs on the GPU unless the caller asks for the
CPU.  Asking for CUDA on a machine without a GPU raises: the port never
carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``device``; raises if CUDA is asked for but
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rec_tpu_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def set_deterministic() -> None:
    """Full-precision, fixed-algorithm numerics on the card.

    PyTorch lets cuDNN convolutions run in TF32 by default; the decoder must
    regenerate the encoder's priors exactly, so TF32 is turned off and the
    convolution algorithms are pinned."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
