"""Serving-engine artifacts on disk (own copy of ``insarseg/engines_io.py``,
format 1), so the port serves an artifact the JAX package saved and the
JAX package reads one the port saved.

One ``.npz`` file: array leaves as raw bytes plus (dtype, shape) tags, so
int8 and bfloat16 survive bit for bit; the tree structure and the other
leaves (floats, ints, bools, None, strings) ride a JSON manifest. Loaded
arrays come back as CPU torch tensors.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch

# dtypes numpy lacks, stored under numpy's name for them (ml_dtypes')
_TORCH_ONLY = {torch.bfloat16: ("bfloat16", torch.int16)}


def _array_bytes(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in _TORCH_ONLY:
        t = t.view(_TORCH_ONLY[t.dtype][1])
    return t.numpy().reshape(-1).view(np.uint8)


def _encode(node: Any, arrays: List[Any]) -> Any:
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"k": "v", "v": node}
    if isinstance(node, (torch.Tensor, np.ndarray, np.generic)):
        arrays.append(node)
        return {"k": "a", "i": len(arrays) - 1}
    if isinstance(node, dict):
        return {"k": "d",
                "v": {k: _encode(v, arrays) for k, v in node.items()}}
    if isinstance(node, tuple):
        return {"k": "t", "v": [_encode(v, arrays) for v in node]}
    if isinstance(node, list):
        return {"k": "l", "v": [_encode(v, arrays) for v in node]}
    raise TypeError(f"cannot serialize engine-tree leaf of type {type(node)}")


def _decode(spec: Any, arrays: Dict[str, torch.Tensor]) -> Any:
    k = spec["k"]
    if k == "v":
        return spec["v"]
    if k == "a":
        return arrays[f"arr_{spec['i']}"]
    if k == "d":
        return {key: _decode(v, arrays) for key, v in spec["v"].items()}
    if k == "t":
        return tuple(_decode(v, arrays) for v in spec["v"])
    if k == "l":
        return [_decode(v, arrays) for v in spec["v"]]
    raise ValueError(f"bad node kind {k!r}")


def save_artifact(path: str, artifact: Dict[str, Any]) -> str:
    """Write an engine artifact (dict with 'tree' + metadata) to ``path``
    (.npz appended if missing). Returns the path written."""
    arrays: List[Any] = []
    spec = _encode(artifact, arrays)
    payload = {"manifest": np.frombuffer(
        json.dumps(spec).encode("utf-8"), np.uint8)}
    meta = []
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            name = _TORCH_ONLY.get(a.dtype, (str(a.dtype).replace(
                "torch.", ""),))[0]
            meta.append({"dtype": name, "shape": list(a.shape)})
            payload[f"arr_{i}"] = _array_bytes(a)
        else:
            a = np.ascontiguousarray(a)
            meta.append({"dtype": str(a.dtype), "shape": list(a.shape)})
            payload[f"arr_{i}"] = a.reshape(-1).view(np.uint8)
    payload["arrmeta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"
    with open(path, "wb") as f:
        np.savez(f, **payload)
    return path


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    raw = np.array(raw, copy=True)
    if dtype == "bfloat16":
        t = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(raw.view(np.dtype(dtype)))
    return t.reshape(shape)


def load_artifact(path: str) -> Dict[str, Any]:
    """Read an artifact written by :func:`save_artifact` (of either
    package). A truncated or tampered file raises ``ValueError``."""
    if not path.endswith(".npz"):
        path += ".npz"
    try:
        with np.load(path) as z:
            spec = json.loads(bytes(z["manifest"]).decode("utf-8"))
            arrmeta = json.loads(bytes(z["arrmeta"]).decode("utf-8"))
            arrays = {}
            for i, m in enumerate(arrmeta):
                if f"arr_{i}" not in z:
                    raise ValueError(
                        f"manifest lists {len(arrmeta)} arrays but arr_{i} "
                        "is missing")
                raw = z[f"arr_{i}"]
                itemsize = 2 if m["dtype"] == "bfloat16" \
                    else np.dtype(m["dtype"]).itemsize
                want = int(np.prod(m["shape"], dtype=np.int64)) * itemsize
                if raw.nbytes != want:
                    raise ValueError(
                        f"arr_{i} holds {raw.nbytes} bytes but the manifest "
                        f"says {m['dtype']}{tuple(m['shape'])} = {want} bytes")
                arrays[f"arr_{i}"] = _from_bytes(raw, m["dtype"], m["shape"])
            return _decode(spec, arrays)
    except ValueError as e:
        raise ValueError(f"corrupt engine artifact {path!r}: {e}") from e
    except (KeyError, TypeError, json.JSONDecodeError) as e:
        raise ValueError(
            f"corrupt engine artifact {path!r}: {type(e).__name__}: {e}"
        ) from e


def to_torch_tree(tree: Any, device: torch.device) -> Any:
    """Copy a packed tree with every array leaf (numpy or torch) as a torch
    tensor on ``device``; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)):
        if tree.dtype.name == "bfloat16":
            return _from_bytes(np.asarray(tree).view(np.uint8), "bfloat16",
                               tree.shape).to(device)
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch_tree(v, device) for v in tree)
    return tree
