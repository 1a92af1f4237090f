"""Device selection shared by every entry point of the port.

``device=None`` means the card. Without one the entry point raises: the port
never carries on quietly on the CPU; a caller that wants the CPU (the tests)
asks for it by name.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and none
    is present. On the card, TF32 is switched off for matmuls and
    convolutions: the SSD cross term cancels at reduced precision, so no
    matmul of the port may round its inputs to TF32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "navdv_torch: no CUDA device is present; pass device='cpu' "
                "to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"navdv_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A NumPy array, sequence or tensor as a contiguous tensor of ``dtype``
    on ``device`` (NumPy values are cast on the host, as the JAX package's
    ``jnp.asarray(x, dtype)`` does)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}[dtype]
    return torch.from_numpy(np.array(x, dtype=np_dtype)).to(device)
