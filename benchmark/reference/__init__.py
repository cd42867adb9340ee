"""The benchmark's plain reference of D3Feat (KPFCNN with its detector head,
losses and SGD step), in plain PyTorch and NumPy.

It imports nothing of the program under test and nothing of the JAX
package. It runs on the card in float32 with TF32 off (``strict_fp32``),
in blocks of rows where a tensor would be large, after the measured
window has closed.
"""

import contextlib

import torch


@contextlib.contextmanager
def strict_fp32():
    """float32 products without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
