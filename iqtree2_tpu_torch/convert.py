"""Host arrays -> torch tensors: a ``ModelPack`` (model/pack.py) or a dict
of numpy arrays (the parity tests feed the JAX engine's pack through here),
and a ``TreeSchedule``'s index arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# model arrays the kernels read (model/pack.py documents each); host-only
# fields of ModelPack (p_invar, mean_freqs) are left behind
_FLOAT_KEYS = ("eigvals", "U", "V", "W", "sqrt_freqs", "Q", "cat_rate",
               "cat_weight", "root_freqs", "log_ptn_invar", "tip_table",
               "asc_mask", "asc_nsites")


def pack_to_torch(pack, device, dtype: torch.dtype) -> dict:
    """ModelPack or dict of numpy arrays -> dict of tensors on ``device``.

    Floating arrays take ``dtype``; ``cat_mix`` becomes int64 (an index);
    absent optional arrays (W, Q, ...) stay None."""
    if dataclasses.is_dataclass(pack):
        items = {f.name: getattr(pack, f.name)
                 for f in dataclasses.fields(pack)}
    else:
        items = dict(pack)
    out = {}
    for k, v in items.items():
        if k == "cat_mix":
            out[k] = torch.as_tensor(np.array(v), dtype=torch.int64,
                                     device=device)
        elif k in _FLOAT_KEYS:
            out[k] = None if v is None else torch.as_tensor(
                np.array(v, np.float64, order="C"), dtype=dtype,
                device=device)
    return out


def sched_to_torch(arrays: dict, device) -> dict:
    """TreeSchedule.to_device_arrays() -> dict of int32 tensors."""
    return {k: torch.as_tensor(np.array(v, np.int32), device=device)
            for k, v in arrays.items()}
