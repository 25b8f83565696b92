"""AclNet-style audio event classifier (counterpart of
``evam_tpu/models/zoo/aclnet.py``).

gvaaudiodetect's model for audio_detection/environment: 16 kHz mono
S16LE windows, normalized to [-1, 1] by the engine step. The 1-D
convolutions are 2-D convs of kernel ``(1, 9)`` over a ``[B, 1, 1, S]``
NCHW input, flax's ``"SAME"`` padding made explicit
(``ops/padding.py``: asymmetric at stride 4 and 2, e.g. 2 left and 3
right at S = 16000, stride 4). Submodules carry flax's auto-names
(``Conv_0..4``, ``Dense_0..1``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from evam_tpu_torch.models.zoo.layers import Conv

#: One-second analysis window at 16 kHz (gvaaudiodetect's contract).
SAMPLE_RATE = 16000
WINDOW_SAMPLES = 16000
#: the five convs' strides along the samples
STRIDES = (4, 4, 4, 4, 2)


class AclNet(nn.Module):
    def __init__(self, num_classes: int = 53, width: int = 32):
        super().__init__()
        in_ch = 1
        for i, stride in enumerate(STRIDES):
            out_ch = width * (2 ** min(i, 3))
            self.add_module(f"Conv_{i}",
                            Conv(in_ch, out_ch, (1, 9), (1, stride)))
            in_ch = out_ch
        self.Dense_0 = nn.Linear(in_ch, 256)
        self.Dense_1 = nn.Linear(256, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: float [B, S] in [-1, 1] → [B, C=1, H=1, W=S]
        x = x[:, None, None, :]
        for i in range(len(STRIDES)):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        x = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(x)
