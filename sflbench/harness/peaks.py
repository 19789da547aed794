"""Published peaks of the cards the benchmark knows (NVIDIA's H100 SXM5
data sheet, dense rates, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 495e12,   # TF32 tensor cores: the fastest f32-input rate
        "f32_flops": 67e12,     # float32 outside the tensor cores
        "hbm_bytes": 3.35e12,   # HBM3 bandwidth, bytes/s
    },
}


def for_device(kind: str):
    """The peaks of ``kind`` (``torch.cuda.get_device_name()``), or None."""
    return PEAKS.get(kind)
