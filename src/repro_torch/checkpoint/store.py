"""Checkpointing, port of ``repro.checkpoint.store``: per-leaf ``.npy``
files and a JSON manifest, atomic save, async writer, restore onto a
given device.

Layout, as the reference's:
    <dir>/step_<n>/
        manifest.json          # step, metadata, each leaf's id/shape/dtype
        <leaf-id>.npy          # one file per tree leaf

Leaf ids are the leaf's path in the port's own tree (dict keys, list
indices and named-tuple field names joined by ``__``, as the reference
joins its pytree paths), so a port checkpoint names ``params__blocks__3
__attn__wq`` where the reference's names ``params__blocks__stack__p0
__attn__wq``.  Saves are atomic (written to ``.tmp_step_<n>``, then
renamed).  :class:`AsyncCheckpointer` copies the tree to host memory
before it returns, so the caller may update the tree in place at once,
and writes on a background thread.  numpy has no bfloat16: such a leaf is
stored as float32 (exact) with ``"bfloat16"`` in the manifest.

On a rank mesh (:func:`repro_torch.launch.mesh.make_rank_mesh`) a tree
holds this rank's blocks: ``save(..., mesh=, specs=)`` all-gathers each
sharded leaf and rank 0 writes it whole, in the same format, once;
``restore(..., mesh=)`` reads each whole leaf and keeps this rank's block
for the mesh's W (:func:`repro_torch.sharding.rules.local_shard` by the
rules' spec of the whole leaf), whatever W saved it: the reference's
elastic reshard.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.sharding import collectives
from repro_torch.sharding.rules import fsdp_dim, local_shard, param_shardings
from repro_torch.train.tree import flatten, spec_list, unflatten_like

def _leaf_id(path) -> str:
    return "__".join(str(k) for k in path) or "leaf"


def _ids(tree) -> list[tuple[str, torch.Tensor]]:
    out, seen = [], set()
    for path, leaf in flatten(tree):
        lid = _leaf_id(path)
        while lid in seen:
            lid += "_"
        seen.add(lid)
        out.append((lid, leaf))
    return out


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _write(items: list, directory: Path, step: int,
           metadata: dict | None) -> Path:
    """Write ``(id, host array, dtype name)`` items as one checkpoint."""
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": []}
    for lid, arr, dtype in items:
        np.save(tmp / f"{lid}.npy", arr)
        manifest["leaves"].append({"id": lid, "shape": list(arr.shape),
                                   "dtype": dtype})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _whole(tree, mesh, specs) -> list[tuple[str, torch.Tensor]]:
    """``(id, leaf)`` of ``tree`` with every leaf whole: on a rank mesh
    each leaf its spec shards over ``data`` all-gathered from the ranks'
    blocks (a copy at one rank)."""
    ids = _ids(tree)
    if not getattr(mesh, "ranks", False):
        return ids
    if specs is None:
        raise ValueError("saving from a rank mesh needs the specs its "
                         "blocks were cut by")
    out = []
    for (lid, leaf), spec in zip(ids, spec_list(specs, tree)):
        dim = fsdp_dim(spec)
        if dim is not None:
            leaf = collectives.all_gather(leaf.detach(), dim, mesh.group)
        out.append((lid, leaf))
    return out


def _snapshot(tree, mesh=None, specs=None) -> list | None:
    """The tree's leaves whole on the host, as ``(id, array, dtype
    name)``; ``None`` on a rank other than 0, which writes nothing."""
    ids = _whole(tree, mesh, specs)
    if getattr(mesh, "rank", 0) != 0:
        return None
    return [(lid, _host(leaf), _dtype_name(leaf)) for lid, leaf in ids]


def save(tree, directory: str | Path, step: int,
         metadata: dict | None = None, mesh=None, specs=None) -> Path:
    """Synchronous atomic save of a tree of tensors (or numpy arrays).  On
    a rank ``mesh`` every rank calls it with its blocks and the spec tree
    they were cut by (``specs``, the tree's structure); rank 0 writes."""
    items = _snapshot(tree, mesh, specs)
    path = Path(directory) / f"step_{step:08d}"
    if items is not None:
        path = _write(items, Path(directory), step, metadata)
    if getattr(mesh, "ranks", False):
        torch.distributed.barrier(group=mesh.group)
    return path


def _step_dir(directory: Path, step: int | None) -> Path:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return directory / f"step_{step:08d}"


def restore(tree_like, directory: str | Path, step: int | None = None,
            device=None, mesh=None):
    """Restore into the structure of ``tree_like`` (shapes checked; its
    leaves may live on the ``meta`` device), each leaf in ``tree_like``'s
    dtype on ``device`` (the CPU unless named).  Returns ``(tree,
    manifest)``; a leaf of ``tree_like`` that requires grad comes back
    requiring grad.  On a rank ``mesh`` each leaf comes back as this rank's
    block of it: cut by the rules' spec of the whole leaf at the mesh's
    ``rules_mesh`` (a train state's moments and residuals then follow their
    parameters, as ``train.step.state_specs`` lays them out)."""
    d = _step_dir(Path(directory), step)
    manifest = json.loads((d / "manifest.json").read_text())
    have = {m["id"] for m in manifest["leaves"]}
    want = _ids(tree_like)
    if len(have) != len(want):
        raise ValueError(f"checkpoint has {len(have)} leaves, target has "
                         f"{len(want)}")
    dev = torch.device("cpu" if device is None else device)
    ranks = getattr(mesh, "ranks", False)
    specs = (spec_list(param_shardings(tree_like, mesh.rules_mesh),
                       tree_like) if ranks else [None] * len(want))
    out = []
    for (lid, leaf), spec in zip(want, specs):
        if lid not in have:
            raise ValueError(f"checkpoint has no leaf {lid}")
        arr = np.load(d / f"{lid}.npy")
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{lid}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(arr)
        if ranks:
            t = local_shard(t, spec, mesh)
        t = t.to(dev, dtype=leaf.dtype)
        if leaf.requires_grad:
            t.requires_grad_(True)
        out.append(t)
    return unflatten_like(tree_like, out), manifest


def load_tree(directory: str | Path, step: int | None = None):
    """A checkpoint as nested dicts of numpy arrays, keyed by the parts of
    each leaf id (bfloat16 leaves as float32): e.g. a reference-written
    params checkpoint, for :func:`repro_torch.models.convert.
    params_from_numpy`.  Returns ``(tree, manifest)``."""
    d = _step_dir(Path(directory), step)
    manifest = json.loads((d / "manifest.json").read_text())
    tree: dict = {}
    for m in manifest["leaves"]:
        *parents, name = m["id"].split("__")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = np.load(d / f"{m['id']}.npy")
    return tree, manifest


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(m.group(1)) for p in directory.iterdir()
             if (m := re.fullmatch(r"step_(\d+)", p.name))]
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write to disk on a worker
    thread; keeps the newest ``keep`` checkpoints."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save(self, tree, step: int, metadata: dict | None = None,
             mesh=None, specs=None):
        """Snapshot ``tree`` (on a rank ``mesh``: every rank, its blocks
        gathered as :func:`save` does) and write it on rank 0 in the
        background."""
        items = _snapshot(tree, mesh, specs)
        if items is None:
            return
        self.wait()

        def work():
            _write(items, self.directory, step, metadata)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1]) for p in
                       self.directory.iterdir()
                       if p.name.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
