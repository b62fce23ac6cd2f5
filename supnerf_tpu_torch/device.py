"""Device selection for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside, its setting before put back
    after. The training CLI runs under it: cuDNN's default weight-gradient
    convolutions of the encoder sum partials in an order that changes from
    run to run, so two training runs from one seed (a run and its resume)
    part from their first step on, where the JAX package's steps repeat.
    Test-time optimization and the demo run the encoder forward only (no
    weight gradients) and run without it."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
