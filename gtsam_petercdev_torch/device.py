"""Device and dtype resolution for the port's entry points.

Every public entry point takes `device=` (default "cuda") and resolves it
here. Without a CUDA device a "cuda" request raises: nothing falls back to
the CPU unless the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return a torch.device; raise if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """torch dtype from a torch/numpy dtype or name; default float64."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    table = {"float32": torch.float32, "float64": torch.float64}
    if name not in table:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return table[name]


def as_float(x, like=None) -> torch.Tensor:
    """x (a Python number or list, a numpy array, a tensor) as a float tensor.

    A tensor passes through; anything else goes through numpy first, so a
    Python number or list is float64 there, as `jnp.asarray` takes it under
    x64 (`torch.as_tensor` would round it to torch's default float32 before
    any later cast), and an integer array becomes float64. A float numpy
    array keeps its dtype. With `like` (a tensor) the result takes its dtype
    and device."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        x = torch.as_tensor(a if a.dtype.kind == "f" else a.astype(np.float64))
    return x if like is None else x.to(like)


def check_graph_values(graph, values, device: DeviceLike) -> torch.device:
    """Resolve `device` and raise unless a graph and its Values (anything
    with a `.device`) live on its type: an entry point moves nothing."""
    dev = resolve_device(device)
    for what, d in (("graph", graph.device), ("values", values.device)):
        if d.type != dev.type:
            raise ValueError(f"{what} is on {d}, optimizer asked for {dev}")
    return dev


def check_on(t: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless tensor `t` lives on `device` (no silent moves)."""
    if t.device.type != device.type or (
        device.index is not None and t.device.index != device.index
    ):
        raise ValueError(f"{what} is on {t.device}, expected {device}")

