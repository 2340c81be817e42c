"""Tree ↔ safetensors interchange: the port's counterpart of
``accelerate_tpu/utils/serialization.py``.

The flattening convention is the JAX package's: nested dict keys joined with ``/``,
list and tuple indices as their decimal string (``utils.tree.named_parameters``), so a
llama's params export under the names of the JAX params tree (``layers/0/wq``).

The ``safetensors`` package is not needed: the format is written and read here. A file
is an 8-byte little-endian header length, a JSON header (``{name: {"dtype", "shape",
"data_offsets"}}`` and an optional ``"__metadata__"`` of strings), padded with spaces to
8 bytes, then the tensors' raw bytes. Tensors are laid out by element size, largest
first, then by name (the order the ``safetensors`` writer uses), so every tensor starts
on a boundary of its element size. bf16 is stored as ``BF16``, never upcast.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

from .tree import named_parameters, unflatten_to_nested_dict

__all__ = ["flatten_pytree", "unflatten_to_nested_dict", "save_pytree_safetensors",
           "load_flat_safetensors", "load_pytree_safetensors", "write_safetensors",
           "read_safetensors", "read_header", "DTYPE_TAGS"]

#: torch dtype → safetensors dtype tag.
DTYPE_TAGS = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
    torch.uint8: "U8", torch.bool: "BOOL", torch.float8_e4m3fn: "F8_E4M3",
    torch.float8_e5m2: "F8_E5M2",
}
_TAG_DTYPES = {tag: dt for dt, tag in DTYPE_TAGS.items()}
for _tag, _dt in (("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64")):
    if hasattr(torch, _dt):
        _TAG_DTYPES[_tag] = getattr(torch, _dt)
        DTYPE_TAGS[getattr(torch, _dt)] = _tag


def flatten_pytree(tree: Any, sep: str = "/") -> dict[str, Any]:
    """A tree of tensors (or arrays) flattened into ``{joined_key: leaf}``."""
    return named_parameters(tree, sep=sep)


def _as_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor of its own dtype (a numpy bfloat16 array
    through its 16-bit words)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu").contiguous()
    arr = np.ascontiguousarray(np.asarray(leaf))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _raw(t: torch.Tensor) -> memoryview:
    """A contiguous CPU tensor's bytes."""
    if t.numel() == 0:
        return memoryview(b"")
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def _dtype_shape(leaf) -> tuple:
    if torch.is_tensor(leaf):
        return leaf.dtype, tuple(leaf.shape)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.bfloat16, arr.shape
    return torch.from_numpy(np.zeros(0, arr.dtype)).dtype, arr.shape


def write_safetensors(flat: dict, file_path, metadata: Optional[dict] = None) -> None:
    """Write ``{name: tensor or array}`` as one safetensors file; each leaf is copied to
    the host only while its bytes are written."""
    meta = {name: _dtype_shape(leaf) for name, leaf in flat.items()}
    for name, (dtype, _) in meta.items():
        if dtype not in DTYPE_TAGS:
            raise ValueError(f"{name}: dtype {dtype} has no safetensors tag")
    size = {dt: torch.empty((), dtype=dt).element_size() for dt, _ in meta.values()}
    order = sorted(meta, key=lambda n: (-size[meta[n][0]], n))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        dtype, shape = meta[name]
        n = int(np.prod(shape, dtype=np.int64)) * size[dtype]
        header[name] = {"dtype": DTYPE_TAGS[dtype], "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(file_path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in order:
            f.write(_raw(_as_tensor(flat[name])))


def read_header(file_path) -> tuple[dict, int]:
    """(the JSON header, the offset of the data) of a safetensors file."""
    with open(file_path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return header, 8 + n


def read_safetensors(file_path, names=None) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` in the header's order (``names``: only those), each a
    CPU tensor over a copy-on-write map of the file (copied where a tensor does not
    start on a boundary of its element size)."""
    header, start = read_header(file_path)
    header.pop("__metadata__", None)
    raw = np.memmap(file_path, dtype=np.uint8, mode="c")
    for name, info in header.items():
        if names is not None and name not in names:
            continue
        dtype = _TAG_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        view = raw[start + begin:start + end]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if (start + begin) % itemsize:
            view = view.copy()
        t = torch.from_numpy(view) if view.size else torch.empty(0, dtype=torch.uint8)
        yield name, t.view(dtype).reshape(tuple(info["shape"]))


def save_pytree_safetensors(tree: Any, file_path, metadata: Optional[dict] = None) -> None:
    """A tree's leaves, flattened, into one safetensors file (dtypes kept, bf16
    included)."""
    write_safetensors(flatten_pytree(tree), file_path, metadata=metadata)


def load_flat_safetensors(file_path) -> dict[str, torch.Tensor]:
    """A safetensors file as ``{joined_key: tensor}`` (bf16 kept); the tensors map the
    file copy-on-write."""
    return dict(read_safetensors(file_path))


def load_pytree_safetensors(file_path) -> dict:
    return unflatten_to_nested_dict(load_flat_safetensors(Path(file_path)))
