"""Numerics debugging: counterpart of medseg_tpu/utils/debug.py.

- `nan_check_mode()`: within the block, the first operation whose floating
  output holds a NaN raises FloatingPointError naming the operation, in the
  forward and in the backward, as the JAX package's jax_debug_nans does.
  It reads every output back, so it synchronizes once an operation: a
  debugging tool that no main path enters.
- `assert_finite(tree, name)`: a host-side finite check over nested dicts,
  lists and tuples of tensors or arrays (a state_dict, say), for use after
  a step where the mode is too slow.  A torch tensor of any floating dtype
  is checked, bfloat16 too (the JAX package's np.asarray test reads a
  bfloat16 array as dtype kind 'V' and passes it).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# operations whose output is memory not yet written: whatever it holds is
# not a result
_UNINITIALIZED = frozenset({"aten::empty", "aten::empty_like", "aten::empty_strided",
                            "aten::empty_permuted", "aten::new_empty",
                            "aten::new_empty_strided", "aten::resize_", "aten::set_"})


class _NanCheck(TorchDispatchMode):
    """Checks the floating outputs of every ATen operation dispatched while
    it is active (but allocations, _UNINITIALIZED).
    torch.autograd.detect_anomaly(check_nan=True) sees only the backward's
    outputs; a dispatch mode sees both passes (the autograd engine carries
    the mode into the backward)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.name().split(".")[0] in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_check_mode() -> Iterator[None]:
    """Raise FloatingPointError at the first operation that produces a NaN
    inside the block; the previous state returns on exit."""
    with _NanCheck():
        yield


def _nonfinite_paths(tree, path: str, bad: List[str]) -> None:
    """Walk the tree as jax.tree_util does (a dict's keys sorted, an
    OrderedDict's in order, None holds no leaf) and append each path
    to a leaf with a non-finite float, in keystr's format."""
    if tree is None:
        return
    if isinstance(tree, dict):
        keys = list(tree) if type(tree) is not dict else sorted(tree)
        for k in keys:
            _nonfinite_paths(tree[k], f"{path}[{k!r}]", bad)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        for k in tree._fields:
            _nonfinite_paths(getattr(tree, k), f"{path}.{k}", bad)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _nonfinite_paths(v, f"{path}[{i}]", bad)
    elif isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and not bool(torch.isfinite(tree).all()):
            bad.append(path)
    else:
        arr = np.asarray(tree)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad.append(path)


def assert_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError listing (at most 5) paths to non-finite
    float leaves of `tree`."""
    bad: List[str] = []
    _nonfinite_paths(tree, "", bad)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
