"""Fault-tolerant checkpointing: async, atomic (counterpart of
``repro/ckpt/checkpoint.py``, in its on-disk format).

  * SAVE: flatten the state tree to named arrays -> write ``.npz`` to
    ``<dir>/tmp.<step>`` -> fsync -> atomic ``rename`` to
    ``step_<step>``.  A crash mid-write never corrupts the latest
    checkpoint.  The host snapshot is taken before the call returns;
    the write runs on a background thread (training continues),
    serialized by a lock; ``keep_last`` old steps are pruned.
  * RESTORE: pick the newest ``step_*`` with a valid manifest and copy
    each leaf into the template's tensor in place (a resume holds one
    state, not two).
  * Multi-process: only rank 0 writes (single-writer); all read.  A
    state of DTensors (a rank mesh) is gathered whole on every rank
    before rank 0 writes it (every rank calls ``save``), and restored
    into whatever placements the restarted job's template has: each
    rank copies its own shards out of the whole leaf, so a state saved
    on a ``(2, 2)`` mesh resumes on ``(4, 1)``.

The format is the reference's, so that each package restores the
other's checkpoints: ``step_<10 digits>/arrays.npz`` plus
``manifest.json`` (``step``, ``time``, ``leaves``, ``dtypes`` and the
caller's extra keys); leaf names are the reference's pytree keys joined
with ``/``, a stack of blocks stored as one array with a leading layer
axis; dtypes in numpy's spelling; bfloat16 and the float8 types stored
as same-width unsigned integers (numpy has no such dtypes), viewed back
on restore through torch's own 16- and 8-bit types.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..models.layers import stacked_leaves

#: numpy cannot hold these: stored as same-width uints; torch reads and
#: writes them through its own integer type of that width
_VIEW_AS = {
    "bfloat16": ("uint16", torch.int16, torch.bfloat16),
    "float8_e4m3fn": ("uint8", torch.uint8, torch.float8_e4m3fn),
    "float8_e5m2": ("uint8", torch.uint8, torch.float8_e5m2),
}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of one leaf (the caller goes on writing into its
    tensors), the types numpy lacks as their uint view; a DTensor
    gathered whole (a collective)."""
    name = _dtype_name(t)
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    if name not in _VIEW_AS:
        return t.to("cpu", copy=True).numpy()
    uint, same_width, _ = _VIEW_AS[name]
    return t.view(same_width).to("cpu", copy=True).numpy().view(uint)


def _flatten(state) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for name, parts, stacked in stacked_leaves(state):
        dtypes[name] = _dtype_name(parts[0])
        flat[name] = (np.stack([_host(p) for p in parts]) if stacked
                      else _host(parts[0]))
    return flat, dtypes


def _shape(parts, stacked) -> tuple:
    shape = tuple(parts[0].shape)
    return (len(parts), *shape) if stacked else shape


def _as_torch(arr: np.ndarray, stored: str) -> torch.Tensor:
    if not arr.flags.c_contiguous:
        arr = arr.copy()
    if stored in _VIEW_AS:
        _, same_width, dtype = _VIEW_AS[stored]
        return torch.from_numpy(arr.view(str(same_width).removeprefix(
            "torch."))).view(dtype)
    return torch.from_numpy(arr)


def _unflatten_into(template, arrays: dict[str, np.ndarray],
                    dtypes: dict[str, str]):
    """Copy the checkpoint's leaves into ``template``'s tensors in
    place; every leaf is checked before any is written."""
    leaves = stacked_leaves(template)
    for name, parts, stacked in leaves:
        if name not in arrays:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = arrays[name]
        if tuple(arr.shape) != _shape(parts, stacked):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs model "
                f"{_shape(parts, stacked)}")
    with torch.no_grad():
        for name, parts, stacked in leaves:
            arr = arrays[name]
            value = _as_torch(arr, dtypes.get(name, str(arr.dtype)))
            for i, p in enumerate(parts):
                _copy_into(p, value[i] if stacked else value)
    return template


def _copy_into(p: torch.Tensor, value: torch.Tensor) -> None:
    """``p.copy_(value)``; a DTensor ``p`` takes this rank's shards of
    the whole ``value`` by its own placements."""
    if not hasattr(p, "device_mesh"):
        p.copy_(value)
        return
    from torch.distributed.tensor import distribute_tensor

    local = distribute_tensor(value.to(p.to_local().device), p.device_mesh,
                              p.placements, src_data_rank=None)
    p.to_local().copy_(local.to_local())


def _has_dtensors(state) -> bool:
    return any(hasattr(p, "device_mesh") for _, parts, _ in
               stacked_leaves(state) for p in parts[:1])


def _process_index() -> int:
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3,
                 process_index: int | None = None):
        self.dir = directory
        self.keep_last = keep_last
        self.proc = _process_index() if process_index is None \
            else process_index
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _write(self, step: int, flat: dict[str, np.ndarray],
               dtypes: dict[str, str], extra: dict):
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": sorted(flat.keys()),
            "dtypes": dtypes,
            **extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state, *, extra: dict | None = None,
             blocking: bool = False):
        """Snapshot to host memory now; write to disk asynchronously.
        A state of DTensors is gathered on every rank (each calls this),
        then written by rank 0."""
        if self.proc != 0 and not _has_dtensors(state):
            return
        flat, dtypes = _flatten(state)  # snapshot before async
        if self.proc != 0:
            return
        extra = dict(extra or {})

        def work():
            with self._lock:
                self._write(step, flat, dtypes, extra)

        self.wait()
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                os.path.join(self.dir, d, "manifest.json")
            ):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, *, step: int | None = None):
        """Copy the checkpoint at ``step`` (the latest by default) into
        ``template``'s tensors in place, on their devices; returns
        ``(template, manifest)``, or ``(None, None)`` when there is none.
        The reference's ``shardings`` are the template's own: a DTensor
        leaf takes its shards of the saved whole leaf by its placements,
        whatever mesh saved it."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            arrays = dict(npz)
        state = _unflatten_into(template, arrays, manifest.get("dtypes", {}))
        return state, manifest
