"""Packed checkpoints: a whole train state as a few contiguous buffers.

Port of ``dahpe_tpu/utils/fast_ckpt.py``, with its on-disk layout (a
directory, so path/sidecar/prune semantics are those of the JAX package)::

    <path>/packed_spec.json     # per-leaf path/shape/dtype + chunk table
    <path>/g<i>.npy             # chunk i (bfloat16 stored as uint16)

A state is a tree of nested dicts whose leaves are tensors (or numpy
arrays). Every leaf is flattened into per-dtype 1-D chunks of about 32 MB
in dtype-major order, so a save is a handful of large copies and plain
``np.save`` writes, and :func:`load_packed_tree` reads the JAX package's
packed checkpoints as well as the port's own (bfloat16 chunks through
``torch.bfloat16``).

The port's optimizers update their tensors in place, so a save must copy
the state before the next step runs: :func:`pack_state` concatenates the
leaves into fresh device buffers on the caller's current stream, which
orders the snapshot before any later update. :class:`AsyncSaver` then copies
the chunks to pinned host memory on a side stream and writes them on a
worker thread, so the training loop keeps stepping while a save drains.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

SPEC_NAME = "packed_spec.json"
CHUNK_BYTES = 32 * 1024 * 1024
_WINDOW = 2  # chunk copies started ahead of the write


def flatten_tree(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs of a tree of nested dicts, keys sorted (the
    order ``jax.tree_util`` flattens dicts in); ``None`` leaves are dropped."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out += flatten_tree(value, prefix + (str(key),))
        elif value is not None:
            out.append((prefix + (str(key),), value))
    return out


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.asarray(leaf))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).rsplit(".", 1)[-1]


def _spec_of(tree) -> tuple[dict, list[torch.Tensor]]:
    """``(spec, leaves)``: per-leaf path/shape/dtype plus the chunk table
    assigning every leaf a (chunk, offset) in dtype-major order (the JAX
    package's ``_spec_of``)."""
    leaves_spec, leaves = [], []
    for path, leaf in flatten_tree(tree):
        t = _as_tensor(leaf)
        leaves_spec.append({"path": [["d", k] for k in path], "shape": list(t.shape),
                            "dtype": _dtype_name(t)})
        leaves.append(t)
    order = sorted(range(len(leaves)), key=lambda i: (leaves_spec[i]["dtype"], i))
    chunks, cur_dtype, cur_elems, cur_members = [], None, 0, []
    for i in order:
        d = leaves_spec[i]["dtype"]
        size = leaves[i].numel()
        per_elem = leaves[i].element_size()
        if d != cur_dtype or (cur_elems + size) * per_elem > CHUNK_BYTES and cur_elems:
            if cur_members:
                chunks.append({"dtype": cur_dtype, "elems": cur_elems, "members": cur_members})
            cur_dtype, cur_elems, cur_members = d, 0, []
        leaves_spec[i]["chunk"] = len(chunks)
        leaves_spec[i]["offset"] = cur_elems
        cur_members.append(i)
        cur_elems += size
    if cur_members:
        chunks.append({"dtype": cur_dtype, "elems": cur_elems, "members": cur_members})
    return {"version": 1, "leaves": leaves_spec, "chunks": chunks}, leaves


class Snapshot:
    """Packed chunks of a state and the event that marks them complete on
    the stream that packed them (``None`` on the CPU)."""

    def __init__(self, spec: dict, chunks: list[torch.Tensor], ready):
        self.spec, self.chunks, self.ready = spec, chunks, ready


def pack_state(tree) -> Snapshot:
    """Copy ``tree`` into fresh packed chunks on its device, on the current
    stream: in-place updates queued after this call cannot reach them."""
    spec, leaves = _spec_of(tree)
    devices = [t.device for t in leaves if t.device.type != "cpu"]
    device = devices[0] if devices else torch.device("cpu")
    chunks = []
    for chunk in spec["chunks"]:
        parts = [leaves[i].to(device, non_blocking=True).reshape(-1) for i in chunk["members"]]
        chunks.append(torch.cat(parts) if len(parts) > 1 else parts[0].clone())
    ready = None
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
    return Snapshot(spec, chunks, ready)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # numpy has none: the uint16 bit pattern
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class _HostCopies:
    """Device→host copies of a snapshot's chunks into pinned memory on a
    side stream, started a window ahead of the consumer."""

    def __init__(self, snap: Snapshot):
        self.snap = snap
        self.on_card = snap.ready is not None
        self.started: list = []
        if self.on_card:
            self.device = snap.chunks[0].device
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_event(snap.ready)

    def _start(self, i: int):
        chunk = self.snap.chunks[i]
        if not self.on_card:
            return chunk, None
        with torch.cuda.stream(self.stream):
            host = torch.empty(chunk.shape, dtype=chunk.dtype, pin_memory=True)
            host.copy_(chunk, non_blocking=True)
            chunk.record_stream(self.stream)
            done = torch.cuda.Event()
            done.record(self.stream)
        return host, done

    def get(self, i: int) -> np.ndarray:
        while len(self.started) < min(len(self.snap.chunks), i + _WINDOW):
            self.started.append(self._start(len(self.started)))
        host, done = self.started[i]
        if done is not None:
            done.synchronize()
        self.started[i] = None  # the chunk's buffers go with the write
        return _to_numpy(host)


def _drain_write(path: str, snap: Snapshot, alive=lambda: True) -> bool:
    """Copy + write chunk by chunk into ``path + ".tmp_pack"``, then swap it
    in; abandon cleanly if ``alive()`` turns false between chunks. Returns
    True when the checkpoint was swapped in."""
    tmp = path + ".tmp_pack"
    if os.path.exists(tmp):
        # a COMPLETE leftover tmp with no checkpoint at `path` means a crash
        # landed between the two renames below: promote it
        if is_packed(tmp) and not is_packed(path):
            os.rename(tmp, path)
        else:
            shutil.rmtree(tmp)
    os.makedirs(tmp)
    copies = _HostCopies(snap)
    for i in range(len(snap.chunks)):
        if not alive():
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        np.save(os.path.join(tmp, f"g{i}.npy"), copies.get(i))
    with open(os.path.join(tmp, SPEC_NAME), "w") as fh:
        json.dump(snap.spec, fh)
    old = path + ".old_pack"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        shutil.rmtree(old)
    return True


def is_packed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, SPEC_NAME))


def resolve_packed(path: str) -> str | None:
    """The readable packed checkpoint for ``path``, surviving a hard kill
    inside :func:`_drain_write`'s directory swap: ``path`` itself, else a
    complete ``.tmp_pack`` (a crash between the renames), else ``.old_pack``.
    ``None`` when none is complete (the spec is written last)."""
    for p in (path, path + ".tmp_pack", path + ".old_pack"):
        if is_packed(p):
            return p
    return None


def save_packed(path: str, tree) -> None:
    """Pack, copy and write ``tree`` now (synchronous)."""
    _drain_write(os.path.abspath(path), pack_state(tree))


def _load_spec(path: str) -> dict:
    with open(os.path.join(path, SPEC_NAME)) as fh:
        return json.load(fh)


def _chunk_host_tensors(path: str, spec: dict) -> list[torch.Tensor]:
    out = []
    for i, chunk in enumerate(spec["chunks"]):
        arr = np.load(os.path.join(path, f"g{i}.npy"))
        if chunk["dtype"] == "bfloat16" and arr.dtype == np.uint16:
            out.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(arr))
    return out


def _unflatten(spec: dict, chunks: list[torch.Tensor]) -> dict:
    root: dict = {}
    for ls in spec["leaves"]:
        size = int(np.prod(ls["shape"], dtype=np.int64))
        flat = chunks[ls["chunk"]][ls["offset"] : ls["offset"] + size]
        node = root
        for _, key in ls["path"][:-1]:
            node = node.setdefault(key, {})
        node[ls["path"][-1][1]] = flat.reshape(ls["shape"])
    return root


def load_packed_tree(path: str) -> dict:
    """Template-free read into nested dicts of CPU tensors (views of the
    chunks), keyed by the saved leaf paths. Reads the JAX package's packed
    checkpoints too: their dataclass fields (``params``, ``batch_stats``,
    ``opt``, ``step`` ...) become dict keys, as its ``load_packed_tree``
    makes them."""
    path = resolve_packed(os.path.abspath(path)) or os.path.abspath(path)
    spec = _load_spec(path)
    return _unflatten(spec, _chunk_host_tensors(path, spec))


def restore_packed(path: str, target, *, device=None) -> dict:
    """Read ``path`` into ``target``'s structure: one upload per chunk to
    ``device`` (default: the device of the target's first leaf), then views.
    The saved leaf paths, shapes and dtypes must match the template exactly;
    a mismatch is a hard error, not a silent merge."""
    path = resolve_packed(os.path.abspath(path)) or os.path.abspath(path)
    spec = _load_spec(path)
    t_spec, leaves = _spec_of(target)
    if t_spec["leaves"] != spec["leaves"]:
        for a, b in zip(t_spec["leaves"], spec["leaves"]):
            if a != b:
                raise ValueError(
                    f"packed checkpoint mismatch at {b['path']}: saved "
                    f"{b['shape']}/{b['dtype']} vs template {a['shape']}/{a['dtype']}"
                )
        raise ValueError(f"packed checkpoint holds {len(spec['leaves'])} leaves, "
                         f"template has {len(t_spec['leaves'])}")
    if device is None:
        device = leaves[0].device if leaves else torch.device("cpu")
    chunks = [c.to(device) for c in _chunk_host_tensors(path, spec)]
    return _unflatten(spec, chunks)


class AsyncSaver:
    """Overlap checkpoint writes with training.

    ``save()`` snapshots the state into fresh packed device buffers NOW (on
    the caller's stream) and hands the copy-and-write to one worker thread;
    the copies run on a side stream into pinned memory. ``link()`` enqueues
    a host-side copy of an already-saved checkpoint (``best`` is the same
    bytes as the epoch save). Jobs run in submission order, so a ``link``
    after its source's ``save`` is safe. A save to a path that a newer save
    supersedes is skipped if still queued and abandoned at its next chunk
    if already draining, once some complete checkpoint exists there.
    ``flush()`` waits for the queue and re-raises the first worker error.
    The bounded queue (default 2 pending) caps the device memory held by
    snapshots.
    """

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error: Exception | None = None
        self._gen: dict[str, int] = {}  # per-path save generation
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:  # close() sentinel
                self._q.task_done()
                return
            try:
                if self._error is None:
                    job()
            except Exception as e:  # surfaced by the next call
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {e}") from e

    def save(self, path: str, tree) -> None:
        self._raise_pending()
        snap = pack_state(tree)
        path = os.path.abspath(path)
        self._gen[path] = gen = self._gen.get(path, 0) + 1

        def job():
            _drain_write(path, snap,
                         alive=lambda: self._gen.get(path) == gen or not is_packed(path))

        self._q.put(job)

    def save_aux(self, path: str, **arrays) -> None:
        """Sidecar write (:func:`checkpoint.save_aux`), ordered after any
        pending state save; the values are copied to the host now."""
        from dahpe_tpu_torch.utils import checkpoint as ckpt

        self._raise_pending()
        host = {k: (None if v is None else ckpt.host_array(v)) for k, v in arrays.items()}
        self._q.put(lambda: ckpt.save_aux(path, **host))

    def run(self, fn) -> None:
        """Enqueue a host-side job (e.g. pruning) after every pending save."""
        self._raise_pending()
        self._q.put(fn)

    def link(self, src: str, dst: str) -> None:
        """Duplicate checkpoint ``src`` at ``dst`` host-side (hard links where
        the filesystem allows, copies otherwise)."""
        self._raise_pending()
        src, dst = os.path.abspath(src), os.path.abspath(dst)

        def job():
            tmp = dst + ".tmp_pack"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            shutil.copytree(src, tmp, copy_function=_link_or_copy)
            old = dst + ".old_pack"
            if os.path.exists(old):
                shutil.rmtree(old)
            if os.path.exists(dst):
                os.rename(dst, old)
            os.rename(tmp, dst)
            if os.path.exists(old):
                shutil.rmtree(old)

        self._q.put(job)

    def flush(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain pending jobs and stop the worker (the saver is unusable
        afterwards)."""
        self._q.join()
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise_pending()


def _link_or_copy(src: str, dst: str, *, follow_symlinks: bool = True) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)
