"""Device selection for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: str | None = "cuda") -> torch.device:
    """'cuda' (the default) or 'cpu'. Asking for CUDA without a card raises
    instead of carrying on on the CPU. On the card, TF32 is switched off for
    matmuls and cuDNN convolutions (cuDNN's default is on), so the port
    computes in float32 end to end."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
