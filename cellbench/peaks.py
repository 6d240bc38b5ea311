"""The table of peaks the rooflines are read against: one NVIDIA H100 SXM,
80 GB HBM3 (NVIDIA's data sheet, dense rates, at the card's full 700 W).
A run states the card's power limit beside every share
(``device.power_limit_w`` of its result line): a card set below 700 W
reaches less than these."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_ops_per_s": 67e12,      # float32 outside the tensor cores
    },
}


def peaks(device_name: str) -> dict:
    """The peaks of the card named ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it); raises ``KeyError`` for a
    card the table lacks, so that no share is read against a guess."""
    return PEAKS[device_name]
