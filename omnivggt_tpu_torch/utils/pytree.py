"""Moving and collating nested dicts, lists and tuples of tensors
(counterpart of omnivggt_tpu/utils/pytree.py).

Leaves are torch tensors or numpy arrays; anything else passes through
unchanged. `to_numpy` is the host copy, `to_device` places every array leaf
on a device as a tensor, and the batch helpers (collate_with_cat,
select_first_batch, invalid_to_nans / _zeros, check_valid_array) follow the
JAX package's semantics on either kind of array.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def tree_map(fn, tree):
    """fn on every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _numpy(x) -> np.ndarray:
    """A host numpy copy of an array leaf; bf16 (which numpy lacks) as fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def to_device(tree, device):
    """Every array leaf as a tensor on `device` (numpy arrays converted)."""
    return tree_map(lambda x: torch.as_tensor(x, device=device) if _is_array(x) else x, tree)


def to_numpy(tree):
    """Every array leaf copied to host numpy (bf16 tensors as fp32)."""
    return tree_map(lambda x: _numpy(x) if _is_array(x) else x, tree)


def to_cpu(tree):
    return to_device(tree, "cpu")


def collate_with_cat(whatever, lists: bool = False):
    """Collate a list of sample trees into a batch tree: batched arrays
    concatenate along dim 0 when their trailing shapes agree (the leading
    dims may differ: variable view counts), scalars stack, anything else
    stays a list; lists=True keeps every array leaf as a list. Tensors stay
    tensors and numpy arrays numpy."""
    if isinstance(whatever, (tuple, list)) and whatever:
        first = whatever[0]
        if isinstance(first, dict):
            return {k: collate_with_cat([d[k] for d in whatever], lists=lists) for k in first}
        if _is_array(first):
            torch_leaves = isinstance(first, torch.Tensor)
            arrs = list(whatever) if torch_leaves else [np.asarray(x) for x in whatever]
            if lists:
                return arrs
            if arrs[0].ndim and all(
                a.ndim == arrs[0].ndim and a.shape[1:] == arrs[0].shape[1:] for a in arrs
            ):
                return torch.cat(arrs) if torch_leaves else np.concatenate(arrs, axis=0)
            if not arrs[0].ndim and all(a.ndim == 0 for a in arrs):
                return torch.stack(arrs) if torch_leaves else np.stack(arrs)
            return arrs
        if isinstance(first, (tuple, list)):
            return type(first)(
                collate_with_cat([x[i] for x in whatever], lists=lists) for i in range(len(first))
            )
    return whatever


def select_first_batch(inputs: dict, dtype=None) -> dict:
    """The standard prediction keys cut to their first batch element, as
    host numpy (`pose_enc_list` becomes its last iterate, `pose_enc`), for
    single-scene export; dtype, a numpy dtype, casts them."""
    keys = {
        "pose_enc", "depth", "world_points", "images", "extrinsic", "intrinsic",
        "world_points_from_depth", "depth_conf", "world_points_conf",
    }
    out = {}
    for key, value in inputs.items():
        if key == "pose_enc_list" and (isinstance(value, list) or _is_array(value)):
            value = value[-1]
            key = "pose_enc"
        if _is_array(value) and key in keys:
            value = _numpy(value[:1])
            if dtype is not None:
                value = value.astype(dtype)
        out[key] = value
    return out


def invalid_to_nans(arr: torch.Tensor, valid_mask, ndim: int = 999) -> torch.Tensor:
    """arr with NaN where valid_mask is False (broadcast over a trailing
    channel axis), flattened to `ndim` axes."""
    if valid_mask is not None:
        mask = valid_mask[..., None] if arr.ndim == valid_mask.ndim + 1 else valid_mask
        arr = torch.where(mask.bool(), arr, torch.nan)
    if arr.ndim > ndim:
        arr = arr.reshape(*arr.shape[: ndim - 2], -1, arr.shape[-1])
    return arr


def invalid_to_zeros(arr: torch.Tensor, valid_mask, ndim: int = 999):
    """(arr with zeros where valid_mask is False, the count of valid
    entries per batch element)."""
    if valid_mask is not None:
        mask = valid_mask[..., None] if arr.ndim == valid_mask.ndim + 1 else valid_mask
        arr = torch.where(mask.bool(), arr, 0)
        nnz = valid_mask.reshape(valid_mask.shape[0], -1).sum(dim=1)
    else:
        nnz = arr.numel() // len(arr) if len(arr) else 0
    if arr.ndim > ndim:
        arr = arr.reshape(*arr.shape[: ndim - 2], -1, arr.shape[-1])
    return arr, nnz


def check_valid_array(x, name: str = "array") -> Optional[str]:
    """NaN/Inf guard over a tensor (on any device; counted there) or an
    array: a message, or None when x is finite (or None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        n_nan, n_inf, size = int(torch.isnan(x).sum()), int(torch.isinf(x).sum()), x.numel()
    else:
        x = np.asarray(x)
        n_nan, n_inf, size = int(np.isnan(x).sum()), int(np.isinf(x).sum()), x.size
    if n_nan or n_inf:
        return f"{name}: {n_nan} NaNs, {n_inf} Infs out of {size}"
    return None
