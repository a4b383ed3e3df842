"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, dense rates without sparsity, at the full power limit)."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    # H100 SXM5 80 GB
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops_per_s": 989e12,
        "fp32_flops_per_s": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "memory_bytes": 80e9,
    },
}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold (its shares then read
    nothing)."""
    return PEAKS.get(kind)
