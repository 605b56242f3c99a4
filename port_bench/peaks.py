"""The card's peaks, from NVIDIA's H100 SXM data sheet (dense, at the
card's full 700 W; a run reports the card's ``power.limit`` beside every
share it gives)."""
H100 = dict(bf16_flops=989e12, fp32_flops=67e12, tf32_flops=495e12, hbm_bytes_per_s=3.35e12)


def peaks(kind: str) -> dict:
    if "H100" not in kind:
        raise ValueError(f"no peak table for {kind!r}")
    return H100
