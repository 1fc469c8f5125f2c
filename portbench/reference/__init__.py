"""The benchmark's plain reference: the networks, the attacks and the
scoring in plain PyTorch, float32, TF32 off.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands it the same state dict, inputs and generator
seeds it hands the program, and it works out everything else again.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict():
    """TF32 off in cuBLAS and cuDNN for the code inside; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
