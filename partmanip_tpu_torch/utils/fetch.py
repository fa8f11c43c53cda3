"""Single-transfer host fetch of scalar metric dicts.

Counterpart of ``partmanip_tpu/utils/fetch.py``: one ``torch.stack`` on the
device plus one copy to the host, instead of one synchronizing ``.item()``
per key.
"""

from __future__ import annotations

import torch


def fetch_scalars(metrics: dict) -> dict:
    """Fetch a dict of on-device scalars as python floats in one transfer."""
    if not metrics:
        return {}
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).reshape(()).float()
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))
