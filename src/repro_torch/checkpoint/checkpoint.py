"""Atomic, async checkpointing with exact resume.

Port of ``repro.checkpoint.checkpoint``, with its on-disk layout:

    <dir>/step_000123/
        manifest.json       # leaf paths, shapes, dtypes, step, extra
        <leaf-path>.npy     # one file per leaf, full logical array

Guarantees:
  * **atomic** — written to ``step_N.tmp-<pid>`` then ``os.rename``d;
    a crash mid-write never corrupts the latest checkpoint;
  * **async** — ``CheckpointManager.save_async`` copies the leaves to host
    memory synchronously and writes in a background thread, so the train
    loop waits only for the device->host copy (the copy is taken even
    for CPU tensors: the trainer updates its state in place);
  * **keep-k** — older step dirs beyond ``keep`` are pruned after a
    successful write (never before);
  * **exact resume** — step counter, optimizer state and RNG state all
    live in the state tree; ``restore`` + the deterministic data
    pipeline reproduce the training trajectory;
  * **restore anywhere** — leaves are full arrays, placed on each
    template leaf's device, or on ``device`` when one is given.

Trees are nested dicts, lists, tuples and dataclasses of tensors
(``repro_torch._tree``); a leaf's file name joins its path's keys with
``_`` (a dataclass field by its index, as the reference's pytree keys
do).  bf16 leaves are stored as float32 (numpy has no bf16); the restore
template casts back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import _tree

MANIFEST = "manifest.json"


def _leaf_path(path) -> str:
    return "_".join(str(k) for k in path)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # not a numpy dtype: stored losslessly as float32
        t = t.to(torch.float32)
    return t.numpy()


def save(state, directory: str, step: int, *, extra: dict | None = None,
         keep: int | None = None) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for path, leaf in _tree.leaves_with_path(state):
        name = _leaf_path(path)
        arr = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape),
             "dtype": (_dtype_name(leaf) if isinstance(leaf, torch.Tensor)
                       else str(arr.dtype))})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomicity point

    if keep is not None:
        _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(directory: str) -> list[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and ".tmp-" not in d:
            try:
                out.append(int(d[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> int | None:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, template, *, step: int | None = None,
            device=None):
    """Restore into the structure of ``template``: each leaf takes its
    template leaf's dtype, and its device unless ``device`` is given.
    Returns (state, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)

    def load(leaf_path, tmpl):
        arr = np.load(os.path.join(path, _leaf_path(leaf_path) + ".npy"))
        dev = tmpl.device if device is None else torch.device(device)
        return torch.as_tensor(arr).to(device=dev, dtype=tmpl.dtype)

    state = _tree.map_with_path(load, template)
    return state, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """Background-thread async saver with keep-k pruning."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, state, step: int, *, extra: dict | None = None):
        self.wait()
        # Synchronous device->host snapshot: the state the thread writes
        # is immune to the train step's later in-place updates.
        host_state = _tree.tree_map(
            lambda x: x.detach().to("cpu", copy=True), state)

        def _write():
            try:
                save(host_state, self.directory, step, extra=extra,
                     keep=self.keep)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self):
        return latest_step(self.directory)
