"""Fault-tolerant checkpointing: atomic and async (counterpart of
``repro.checkpoint.checkpointer``).

- ATOMIC: writes land in ``step_<k>.tmp`` and are renamed to ``step_<k>`` only
  after the manifest fsyncs — a preempted writer can never leave a torn
  checkpoint that restore would pick up.
- ASYNC: ``save_async`` snapshots to host memory synchronously (a copy of
  every leaf, never a view: a later in-place write to the state cannot reach
  the pending write) and writes to disk on a daemon thread.
- RETENTION: ``keep`` newest checkpoints are retained, older ones pruned.

The on-disk format is the reference's: one ``leaf_<i>.npy`` per leaf and a
``manifest.json`` with ``step``, a ``treedef`` description, ``leaves``
(``file``, the numpy ``dtype`` name, ``shape`` as a list) and optional
``specs`` and ``meta``.  A bf16 leaf is written as its 16-bit patterns
(int16) under the reference's name ``"bfloat16"``, and a ``"bfloat16"``
leaf (the reference's 2-byte void, or int16) restores as a bf16 tensor,
bitwise, without ml_dtypes.  Leaves are numbered in JAX's pytree order —
NamedTuple fields in order, lists and tuples in order, dict keys sorted,
``None`` a node with no leaves — so a checkpoint written by either package
restores in the other.  The reference places a restored state onto a mesh
(``shardings=``); here ``restore(device=...)`` places it on a device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["Checkpointer"]

_MANIFEST = "manifest.json"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    return [tree]


def _unflatten(like: Any, leaves: Iterator) -> Any:
    """``like``'s structure with its leaves taken from ``leaves`` in order."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(sub, leaves) for sub in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    if isinstance(like, dict):
        filled = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: filled[key] for key in like}
    return next(leaves)


def _describe(tree: Any) -> str:
    """A readable structure string for the manifest (``*`` per leaf)."""
    if tree is None:
        return "None"
    if _is_namedtuple(tree):
        return f"{type(tree).__name__}({', '.join(_describe(s) for s in tree)})"
    if isinstance(tree, list):
        return f"[{', '.join(_describe(s) for s in tree)}]"
    if isinstance(tree, tuple):
        return f"({', '.join(_describe(s) for s in tree)})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


# numpy has no bfloat16: a bf16 leaf is stored as its 16-bit patterns (an
# int16 ``.npy``) under the reference's dtype name, which names ml_dtypes'
# bfloat16 (written by ``np.save`` as 2-byte void, ``V2``).
_BF16 = "bfloat16"
_BF16_ON_DISK = (np.dtype(np.int16), np.dtype(np.uint16))


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """A numpy copy of one leaf on the host (never a view of its memory) and
    its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (``"float32"``; ``"bfloat16"`` for a
    bf16 tensor), or ``""`` for a leaf without one."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    dtype = getattr(leaf, "dtype", None)
    return "" if dtype is None else str(np.dtype(dtype))


def _load_leaf(path: Path, dtype: str):
    """A leaf file as numpy, or a ``"bfloat16"`` leaf (2-byte void, int16
    or uint16 on disk) as a bf16 tensor, bitwise."""
    arr = np.load(path)
    if dtype != _BF16:
        return arr
    if arr.dtype.itemsize != 2 or (arr.dtype.kind != "V" and arr.dtype not in _BF16_ON_DISK):
        raise ValueError(f"{path.name}: a bfloat16 leaf stored as {arr.dtype}")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(
        self,
        step: int,
        state: Any,
        specs: Any | None = None,
        meta: dict | None = None,
    ):
        """Synchronous atomic save.

        ``meta``: optional JSON-serialisable dict stored verbatim in the
        manifest and returned by :meth:`read_meta` — the slot for state that
        is not an array leaf (a tenant's ``FreqOpSpec`` recipe, quantizer bit
        width, version counters).  ``specs`` remain repr-only provenance.
        """
        self.wait()
        self._write(step, self._snapshot(state), specs, meta)

    def save_async(
        self,
        step: int,
        state: Any,
        specs: Any | None = None,
        meta: dict | None = None,
    ):
        """Snapshot now (device->host copies), write on a daemon thread."""
        self.wait()
        snap = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, specs, meta), daemon=True
        )
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, state: Any):
        return [_host_copy(leaf) for leaf in _flatten(state)], _describe(state)

    def _write(self, step: int, snap, specs, meta=None):
        leaves, treedef = snap
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "treedef": treedef, "leaves": []}
        for i, (leaf, dtype) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, leaf)
            manifest["leaves"].append(
                {"file": fname, "dtype": dtype, "shape": list(leaf.shape)}
            )
        if specs is not None:
            manifest["specs"] = [repr(s) for s in _flatten(specs)]
        if meta is not None:
            manifest["meta"] = meta
        with open(tmp / _MANIFEST, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / _MANIFEST).exists():  # torn dirs (no manifest) ignored
                    out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> Path:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return self.dir / f"step_{step:010d}"

    def read_meta(self, step: int | None = None) -> dict:
        """The ``meta`` dict stored with :meth:`save` (``{}`` when absent)."""
        manifest = json.loads((self._step_dir(step) / _MANIFEST).read_text())
        return manifest.get("meta", {})

    def restore(self, like: Any, step: int | None = None, device=None):
        """Restore into the structure of ``like`` (a state of tensors, or
        of arrays).

        Every leaf is validated against the manifest's recorded shape AND
        dtype — a float state restored into a quantized ``like`` (same leaf
        count, different accumulator dtype) fails loudly instead of silently
        decoding int32 code sums as float32 garbage.

        A tensor leaf of ``like`` comes back as a tensor on its device; any
        other leaf as a numpy array.  ``device``: place every leaf on this
        device instead, as a tensor.
        """
        d = self._step_dir(step)
        manifest = json.loads((d / _MANIFEST).read_text())
        leaves = _flatten(like)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"state expects {len(leaves)}"
            )
        problems = []
        for i, (leaf, entry) in enumerate(zip(leaves, manifest["leaves"])):
            want_shape = tuple(getattr(leaf, "shape", ()))
            want_dtype = _dtype_name(leaf)
            if tuple(entry["shape"]) != want_shape:
                problems.append(
                    f"leaf {i}: checkpoint shape {tuple(entry['shape'])} != "
                    f"state shape {want_shape}"
                )
            elif want_dtype and entry["dtype"] != want_dtype:
                problems.append(
                    f"leaf {i}: checkpoint dtype {entry['dtype']} != "
                    f"state dtype {want_dtype}"
                )
        if problems:
            raise ValueError(
                f"checkpoint {d.name} does not fit the requested state "
                "(wrong state flavour — e.g. quantized vs float?):\n"
                + "\n".join(problems)
            )
        loaded = []
        for leaf, entry in zip(leaves, manifest["leaves"]):
            arr = _load_leaf(d / entry["file"], entry["dtype"])
            target = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else None)
            if target is not None:
                arr = (arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)).to(target)
            elif isinstance(arr, torch.Tensor):
                arr = arr.view(torch.int16).numpy()  # a bf16 leaf into a numpy state: its bits
            loaded.append(arr)
        return _unflatten(like, iter(loaded))
