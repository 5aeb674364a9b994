"""Training checkpoint and resume, joined to the loader cursors.

The port of the JAX package's ``checkpoint.py`` (orbax there,
``torch.distributed.checkpoint`` here, which needs no process group on
one device and reshards DTensors where there is a mesh). The stream side
of resume is the loaders' own (``ClipLoader.state()``,
``ClipDataset.state()``); this module adds the model side and keeps the
loader's cursor beside it as JSON, so one checkpoint directory resumes
both the train state and the place in the corpus:

    ckpt = TrainCheckpointer("/ckpts", max_to_keep=3)
    ckpt.save(step, {"model": model, "opt": optimizer, "gen": generator},
              loader_state=loader.state())
    ...
    step, state, cursor = ckpt.restore(
        template={"model": model, "opt": optimizer, "gen": generator})

A state is a tree of dicts (string keys), lists and tuples whose leaves
are tensors, ``nn.Module``s (their ``state_dict()``),
``torch.optim.Optimizer``s (each parameter's state and each group's
settings), ``torch.Generator``s (``get_state()``) and plain values (int,
float, str, bool, None).

Restoring into a template writes into the template's own storage: the
parameters and buffers, the optimizer's state tensors (``step`` too,
which capturable Adam keeps on the device) and the generators' states
(``set_state`` writes the generator's state object, the one a CUDA graph
registered). So a train step captured as a CUDA graph before the restore
replays on the restored values. An optimizer without state gets its
state made first (a step at lr 0 over zero gradients, as
``torch.distributed.checkpoint.state_dict`` does), so build a graphed
train step, which makes the optimizer capturable, before restoring into
a fresh one. A template whose tree, shapes or dtypes differ from the
checkpoint's raises; nothing is swapped for new storage.

Layout: ``<directory>/<step>/`` holds ``state/`` (the DCP files),
``tree.json`` (the tree) and ``loader.json`` (the cursor, when given). A
step is written under a temporary name and renamed into place whole.

On a mesh (a process group is initialized) every rank calls ``save`` and
``restore``: DCP writes each rank's shards of DTensor leaves once, and
restores them into the template's placements, which may be another
mesh's (a reshard); rank 0 alone makes, renames and prunes the
directories, between barriers.
"""
import json
import os
import shutil
import warnings
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ._device import resolve_device

_PLAIN = (int, float, str, bool, type(None))


def _dcp(call, state, path):
    """``dcp.save`` or ``dcp.load`` of a flat state at `path`; without a
    process group it runs in this process alone (DCP warns of that on
    every call, which says nothing here)."""
    single = not _distributed()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled")
        call(state, checkpoint_id=path, no_dist=single)


def _distributed():
    return dist.is_available() and dist.is_initialized()


def _barrier():
    if _distributed():
        dist.barrier()


def _lead():
    """Whether this process manages the checkpoint's directories."""
    return not _distributed() or dist.get_rank() == 0


def _make_state(optimizer: torch.optim.Optimizer) -> None:
    """Makes an optimizer's lazy state: one step at lr 0 over zero
    gradients (the parameters keep their values), the gradients as they
    were afterwards."""
    params = [p for g in optimizer.param_groups for p in g["params"]
              if p.requires_grad]
    grads = [p.grad for p in params]
    for p in params:
        p.grad = torch.zeros_like(p)
    lrs = [g.get("lr") for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        if "lr" in g:
            g["lr"] = (torch.zeros_like(g["lr"])
                       if isinstance(g["lr"], torch.Tensor) else 0.0)
    try:
        optimizer.step()
    finally:
        for g, lr in zip(optimizer.param_groups, lrs):
            if "lr" in g:
                g["lr"] = lr
        for p, grad in zip(params, grads):
            p.grad = grad


def _flatten(tree, path, flat, saved=None):
    """The JSON description of `tree`; its tensors and values go into
    `flat` under path keys (``a/b/0``). `saved` is the checkpoint's
    description of the same subtree when `tree` is a restore's template:
    an optimizer without state whose checkpoint has some gets it made."""
    saved = saved or {}
    if isinstance(tree, torch.Tensor):
        flat[path] = tree
        return {"tensor": path}
    if isinstance(tree, torch.nn.Module):
        state = tree.state_dict()
        for name, t in state.items():
            flat[f"{path}/{name}"] = t
        return {"module": path, "keys": list(state)}
    if isinstance(tree, torch.optim.Optimizer):
        if saved.get("state") and not tree.state:
            _make_state(tree)
        params = [p for g in tree.param_groups for p in g["params"]]
        state = {}
        for i, p in enumerate(params):
            if p in tree.state:
                state[str(i)] = list(tree.state[p])
                for k, v in tree.state[p].items():
                    flat[f"{path}/state/{i}/{k}"] = v
        groups = []
        for g, group in enumerate(tree.param_groups):
            groups.append([k for k in group if k != "params"])
            for k in groups[-1]:
                flat[f"{path}/groups/{g}/{k}"] = group[k]
        return {"optimizer": path, "state": state, "groups": groups}
    if isinstance(tree, torch.Generator):
        flat[path] = tree.get_state()
        return {"generator": path}
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str):
                raise TypeError(f"state dict keys must be str, got {k!r} at "
                                f"{path or '/'}")
        inner = saved.get("dict") or {}
        return {"dict": {k: _flatten(v, f"{path}/{k}", flat, inner.get(k))
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        inner = saved.get(type(tree).__name__) or []
        return {type(tree).__name__: [
            _flatten(v, f"{path}/{i}", flat,
                     inner[i] if i < len(inner) else None)
            for i, v in enumerate(tree)]}
    if isinstance(tree, _PLAIN):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{path or '/'}")


def _write_back(tree, spec, flat):
    """After a load into `tree`'s own storage: sets what cannot be loaded
    in place (generator states, an optimizer's plain values) and returns
    the tree with the checkpoint's plain values in new containers."""
    if isinstance(tree, torch.optim.Optimizer):
        params = [p for g in tree.param_groups for p in g["params"]]
        for i, keys in spec["state"].items():
            st = tree.state[params[int(i)]]
            for k in keys:
                if not isinstance(st[k], torch.Tensor):
                    st[k] = flat[f"{spec['optimizer']}/state/{i}/{k}"]
        for g, keys in enumerate(spec["groups"]):
            group = tree.param_groups[g]
            for k in keys:
                if not isinstance(group[k], torch.Tensor):
                    group[k] = flat[f"{spec['optimizer']}/groups/{g}/{k}"]
    elif isinstance(tree, torch.Generator):
        tree.set_state(flat[spec["generator"]])
    elif isinstance(tree, dict):
        return {k: _write_back(v, spec["dict"][k], flat)
                for k, v in tree.items()}
    elif isinstance(tree, (list, tuple)):
        return type(tree)(_write_back(v, s, flat)
                          for v, s in zip(tree, spec[type(tree).__name__]))
    elif "value" in spec:
        return spec["value"]
    return tree


def _shape(spec):
    """A tree's description without its plain values."""
    if "value" in spec:
        return {"value": None}
    for key in ("dict", "list", "tuple"):
        if key in spec:
            parts = spec[key]
            return {key: ({k: _shape(v) for k, v in parts.items()}
                          if key == "dict" else [_shape(v) for v in parts])}
    return spec


def _build(spec, flat, device):
    """The state of a checkpoint restored without a template: tensors on
    `device` (a generator's state stays a CPU byte tensor, as
    ``set_state`` takes it), a module as its state dict, an optimizer as
    ``{"state": {index: {name: value}}, "param_groups": [{...}]}``."""
    if "tensor" in spec:
        return _on(flat[spec["tensor"]], device)
    if "generator" in spec:
        return flat[spec["generator"]]
    if "module" in spec:
        return {k: _on(flat[f"{spec['module']}/{k}"], device)
                for k in spec["keys"]}
    if "optimizer" in spec:
        p = spec["optimizer"]
        return {"state": {int(i): {k: _on(flat[f"{p}/state/{i}/{k}"], device)
                                   for k in keys}
                          for i, keys in spec["state"].items()},
                "param_groups": [{k: _on(flat[f"{p}/groups/{g}/{k}"], device)
                                  for k in keys}
                                 for g, keys in enumerate(spec["groups"])]}
    if "dict" in spec:
        return {k: _build(v, flat, device) for k, v in spec["dict"].items()}
    if "list" in spec:
        return [_build(v, flat, device) for v in spec["list"]]
    if "tuple" in spec:
        return tuple(_build(v, flat, device) for v in spec["tuple"])
    return spec["value"]


def _on(value, device):
    return value.to(device) if isinstance(value, torch.Tensor) else value


class TrainCheckpointer:
    """Step-managed checkpoints of a train state and a loader cursor.

    ``max_to_keep`` prunes the oldest steps after each save (None keeps
    every step)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, loader_state: Optional[dict] = None,
             force: bool = False) -> bool:
        """Writes `state` and the JSON-serializable `loader_state` at
        `step`; returns False, writing nothing, when `step` is already
        saved. ``force`` is accepted for the JAX package's signature: every
        call writes (there is no save interval)."""
        step = int(step)
        saved = step in self.all_steps()
        _barrier()          # every rank has seen the steps before writing
        if saved:
            return False
        flat = {}
        spec = _flatten(state, "", flat)
        tmp = os.path.join(self.directory, f".{step}.tmp")
        if _lead():
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        _barrier()
        _dcp(dcp.save, flat, os.path.join(tmp, "state"))
        if _lead():
            with open(os.path.join(tmp, "tree.json"), "w") as f:
                json.dump(spec, f)
            if loader_state is not None:
                with open(os.path.join(tmp, "loader.json"), "w") as f:
                    json.dump(loader_state, f)
            os.rename(tmp, self._step_dir(step))
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old))
        _barrier()
        return True

    def restore(self, step: Optional[int] = None, template: Any = None,
                device=None, device_index: int = 0
                ) -> Tuple[int, Any, Optional[dict]]:
        """(step, state, loader_state or None) of `step` (default the
        latest).

        With a `template` (the live tree: modules, optimizers, generators,
        tensors) the checkpoint is written into the template's storage in
        place, and the state returned holds the template's objects (and
        the checkpoint's plain values). With ``template=None`` the state comes
        back as new tensors on `device` (default ``cuda:<device_index>``;
        ``"cpu"`` when asked)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint steps in {self.directory}")
        root = self._step_dir(step)
        if not os.path.isdir(root):
            raise FileNotFoundError(f"no checkpoint at step {step} in "
                                    f"{self.directory}")
        with open(os.path.join(root, "tree.json")) as f:
            saved = json.load(f)
        path = os.path.join(root, "state")
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        if template is None:
            device = resolve_device(device, device_index)
            flat = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                        if hasattr(m, "size") else None)
                    for k, m in meta.items()}
            _dcp(dcp.load, flat, path)
            state = _build(saved, flat, device)
        else:
            flat = {}
            spec = json.loads(json.dumps(_flatten(template, "", flat,
                                                  saved)))
            if _shape(spec) != _shape(saved):
                raise ValueError(
                    "the template's tree differs from the checkpoint's "
                    f"at step {step}: "
                    f"{_difference(_shape(spec), _shape(saved))}")
            for k, t in flat.items():
                m = meta[k]
                if isinstance(t, torch.Tensor) and (
                        not hasattr(m, "size")
                        or tuple(t.shape) != tuple(m.size)
                        or t.dtype != m.properties.dtype):
                    raise ValueError(
                        f"{k}: the template holds {t.dtype} "
                        f"{tuple(t.shape)}, the checkpoint "
                        f"{getattr(m, 'properties', m)} "
                        f"{tuple(getattr(m, 'size', ()))}")
            _dcp(dcp.load, flat, path)
            state = _write_back(template, saved, flat)
        loader = None
        if os.path.exists(os.path.join(root, "loader.json")):
            with open(os.path.join(root, "loader.json")) as f:
                loader = json.load(f)
        return int(step), state, loader

    def close(self):
        """Nothing to release: every save is written when it returns."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _difference(a, b, at=""):
    """The first place where two tree descriptions differ."""
    if type(a) is not type(b):
        return f"{at or '/'}: {a!r} against {b!r}"
    if isinstance(a, dict):
        if set(a) != set(b):
            return f"{at or '/'}: keys {sorted(a)} against {sorted(b)}"
        for k in a:
            if a[k] != b[k]:
                return _difference(a[k], b[k], f"{at}/{k}")
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{at or '/'}: {len(a)} items against {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _difference(x, y, f"{at}/{i}")
    return f"{at or '/'}: {a!r} against {b!r}"
