"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
dense rates without sparsity, at the full power limit)."""

from __future__ import annotations

from typing import Optional

# name fragment of torch.cuda.get_device_name() -> peaks
CARDS = {
    "H100 80GB HBM3": {   # H100 SXM, 700 W
        "bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
        "float32": 67e12, "float8": 1979e12, "bytes_per_s": 3.35e12,
    },
}


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind``, or ``None`` for a card the
    table does not hold (its shares of peak are then not reported)."""
    for fragment, p in CARDS.items():
        if fragment in kind:
            return p
    return None
