"""Atomic, async checkpoints in the reference's on-disk layout.

The counterpart of ``repro/checkpoint/store.py``, file for file: a save
writes ``step_K.tmp/leaf_{i}.npy`` (one ``.npy`` per leaf, in JAX's
flatten order, :func:`repro_torch.tree.leaves`) and ``manifest.json``
(step, leaf count, the tree's structure as text, each leaf's shape and
dtype, ``extra``), then renames the directory to ``step_K/``, so a
crashed writer never leaves a checkpoint that ``restore`` would take, and
prunes all but the ``keep`` newest.  The same trees give the same leaves
in the same order in both packages, so each restores the other's
checkpoints.

``save(..., blocking=False)`` copies every leaf to host memory on the
caller's thread (training then overwrites the tensors freely) and writes
the files on a writer thread; ``wait()`` joins it, as the next save does
first.  numpy has no bfloat16: a bf16 leaf is written as float32 values
(exact) with ``"bfloat16"`` in the manifest, and ``restore`` casts every
leaf to the dtype of ``tree_like``'s leaf.

**Elastic restore**: the manifest stores logical shapes and dtypes, never
a mesh.  ``restore(..., shardings=)`` re-shards every leaf onto the
*current* mesh: ``shardings`` is a tree of
:class:`repro_torch.launch.shardings.NamedSharding` (a spec over a
``DeviceMesh``) matching ``tree_like``, and each rank keeps its block of
each leaf (``distribute_tensor``, as the reference's ``jax.device_put``,
``:97-118``), on the mesh's device.  Without ``shardings`` a leaf comes
back on the device of ``tree_like``'s.  A save of DTensor leaves (a
sharded job) gathers each one whole on every rank (``full_tensor``, so
every rank must call ``save``) and rank 0 alone writes, in the same
leaf order and layout, so a checkpoint saved by 8 ranks restores onto 4,
onto one card, or in the reference.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.sharding import is_dtensor
from repro_torch.tree import children, leaves, unflatten


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of a leaf that later in-place updates do not touch (a
    DTensor's whole value)."""
    x = x.detach()
    if is_dtensor(x):
        x = x.full_tensor()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.to("cpu", copy=True).numpy()


def _structure(tree) -> str:
    """The tree's nesting and names as text, for the manifest."""
    kids = children(tree)
    if kids is None:
        return "*"
    return "{" + ", ".join(f"{k}: {_structure(c)}" for k, c in kids) + "}"


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        ts = leaves(tree)
        host = [_host(x) for x in ts]
        sharded = any(is_dtensor(x) for x in ts)
        if sharded and torch.distributed.get_rank() != 0:
            return                      # rank 0 writes the gathered leaves
        dtypes = [str(x.dtype).replace("torch.", "") for x in ts]
        structure = _structure(tree)

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "n_leaves": len(host),
                        "treedef": structure, "leaves": [],
                        "extra": extra or {}}
            for i, (arr, dt) in enumerate(zip(host, dtypes)):
                np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                manifest["leaves"].append({"shape": list(arr.shape),
                                           "dtype": dt})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._prune()

        if blocking:
            write()
            return

        def background():
            try:
                write()
            except BaseException as exc:  # noqa: BLE001 - re-raised by wait
                self._error = exc

        self._thread = threading.Thread(target=background, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def wait(self) -> None:
        """Join the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        steps = [int(name.split("_")[1]) for name in os.listdir(self.dir)
                 if name.startswith("step_") and not name.endswith(".tmp")
                 and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json"))]
        return max(steps) if steps else None

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """(a tree shaped as ``tree_like`` holding step ``step``'s leaves,
        default the latest; the manifest).  With ``shardings`` (a tree of
        ``NamedSharding`` matching ``tree_like``) each leaf comes back as
        a DTensor over its mesh, this rank holding its block."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = leaves(tree_like)
        if len(like) != manifest["n_leaves"]:
            raise ValueError(f"checkpoint step {step} holds "
                             f"{manifest['n_leaves']} leaves, the tree "
                             f"{len(like)}")
        shards = (leaves(shardings) if shardings is not None
                  else [None] * len(like))
        if len(shards) != len(like):
            raise ValueError(f"{len(shards)} shardings for {len(like)} "
                             f"leaves")
        out = []
        for i, (ref, shd) in enumerate(zip(like, shards)):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint step {step} leaf {i}: shape "
                                 f"{arr.shape}, the tree's "
                                 f"{tuple(ref.shape)}")
            x = torch.from_numpy(arr)
            if shd is None:
                out.append(x.to(device=ref.device, dtype=ref.dtype))
                continue
            from torch.distributed.tensor import distribute_tensor
            mesh = shd.mesh
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if mesh.device_type == "cuda" else
                   torch.device(mesh.device_type))
            out.append(distribute_tensor(          # elastic re-shard
                x.to(device=dev, dtype=ref.dtype), mesh, shd.placements,
                src_data_rank=None))
        return unflatten(tree_like, out), manifest

    # ------------------------------------------------------------------ #
    def _prune(self) -> None:
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                       if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
