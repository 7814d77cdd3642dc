"""Device choice and precision policy of the port's entry points.

The entry points (``P2RNet``, the demo runner, the CLI) run on the card:
inside a data-parallel process group the card ``parallel.init_distributed``
made current (``cuda:<LOCAL_RANK>``).  They take the CPU only when the caller
asks for it (``device="cpu"``, as the tests do); without a card and without
that request they raise rather than fall back.

Precision: every float32 matrix product and convolution runs in full f32.
PyTorch runs cuDNN convolutions in TF32 by default, which keeps ~3 decimal
digits and flips near-tie FPS / top-k selections downstream, so the entry
points switch TF32 off and the generate path asserts it stays off.
"""

import torch

from pose2room_tpu_torch.parallel.collectives import in_group


def set_precision_policy():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def assert_precision_policy():
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is on: the f32 generate path needs full-f32 matmuls "
            "(call pose2room_tpu_torch.device.set_precision_policy())"
        )


def resolve_device(device=None):
    """``torch.device`` for an entry point: the card unless told otherwise
    (in a process group, this rank's card)."""
    set_precision_policy()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        if in_group():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
