"""Checkpoints, resume and the `encoder.npz` interchange (port of
cmx/ckpt/checkpoint.py).

Two formats, as in cmx, with one difference:
  * Resume files. `CheckpointManager` keeps the newest `max_to_keep`
    `step_<N>.pt` files of `torch.save`: the model's state_dict (parameters
    and BN running stats), the optimizer's state_dict, the task's `extra`
    (each module's state_dict, each tensor: MoCo's key encoder, queue and
    pointer; CM-UNet's target and reduce kernel), the step, the seed and
    the save's metrics;
    beside them `best_metric.json` and `config.json`, as cmx's. cmx's resume
    files are orbax checkpoints of its TrainState: neither package reads the
    other's.
  * The interchange. `export_encoder` / `export_model` write, and
    `load_encoder` / `load_model_npz` read, cmx's flat `.npz` exactly:
    `params/...` and `batch_stats/...` names under the `encoder` subtree
    (`export_model`: the whole tree), flax layouts. An `encoder.npz` written
    by either package loads in the other; `write_stamp` writes cmx's
    provenance stamp beside it.
Under data parallel rank 0 alone writes (every rank waits for it at a
barrier, `parallel.dist.on_main`); every rank restores the same file.

cmx's variables are a flax tree {"params": ..., "batch_stats": ...}; the
port keeps flax's names on its parameters and buffers
(`encoder/down1/double_conv/conv0/kernel` <-> `encoder.down1.double_conv.
conv0.kernel`), so the map (`to_flax` / `from_flax`) is mechanical. Layouts
that differ:
  * Conv kernels: flax HWIO <-> torch OIHW;
  * ConvTranspose kernels (2x2 and LightDecoder's 4x4, and
    PixelShuffleUpsample2x's, which keeps ConvTranspose's parameters):
    flax (kh,kw,I,O) <-> torch (I,O,kh,kw) with a spatial flip
    (lax.conv_transpose correlates with the kernel as given; torch applies
    the conv-gradient kernel);
  * mask tokens: flax (1,1,1,C) <-> torch (1,C,1,1).
Dense kernels (the CM-UNet necks) are kept in flax's (in, out) layout in
the port and cross as they are.
The task states cross the same way: MoCo's cmx extra {"key_params",
"key_batch_stats", "queue", "queue_ptr"} <-> the port's {"key_model",
"queue", "queue_ptr"}; CM-UNet's {"target_params", "target_batch_stats",
"reduce_kernel"} <-> {"target_model", "reduce_kernel"} (the reduce kernel
HWIO (1, 1, 1024, 256) in both). Leaves are numpy arrays.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from cmx_torch.parallel.dist import on_main
from cmx_torch.train.state import TrainState


def _kind(module: nn.Module, name: str) -> str:
    """The layout a parameter crosses in: a `kernel` takes its owner's
    declared `kernel_layout` (Conv "conv"; ConvTranspose and its subclasses,
    PixelShuffleUpsample2x and every LightDecoder `up`, "conv_transpose"),
    so no module's kernel crosses by its class name alone."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf == "kernel":
        return getattr(owner, "kernel_layout", "plain")
    if leaf.startswith("mask_token"):
        return "token"
    return "plain"


def _to_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "conv_transpose":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "token":
        return a.transpose(0, 3, 1, 2)
    return a


def _to_flax_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(2, 3, 1, 0)
    if kind == "conv_transpose":
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    if kind == "token":
        return a.transpose(0, 2, 3, 1)
    return a


def _get(tree: Dict[str, Any], name: str):
    node = tree
    for k in name.split("."):
        node = node[k]
    return node


def _set(tree: Dict[str, Any], name: str, value) -> None:
    *path, leaf = name.split(".")
    node = tree
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = value


@torch.no_grad()
def from_flax(module: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Load cmx's {"params", "batch_stats"} tree (numpy leaves) into
    `module` in place; every parameter and buffer must be present."""
    for name, p in module.named_parameters():
        a = np.asarray(_get(variables["params"], name), dtype=np.float32)
        a = np.array(_to_torch_layout(a, _kind(module, name)), order="C")
        if a.shape != tuple(p.shape):
            raise ValueError(f"{name}: flax {a.shape} vs torch {tuple(p.shape)}")
        p.copy_(torch.from_numpy(a))
    for name, b in module.named_buffers():
        a = np.array(_get(variables["batch_stats"], name), dtype=np.float32)
        b.copy_(torch.from_numpy(a))
    return module


@torch.no_grad()
def to_flax(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters and buffers as cmx's tree of numpy arrays."""
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, p in module.named_parameters():
        a = p.detach().float().cpu().numpy()
        _set(out["params"], name,
             np.ascontiguousarray(_to_flax_layout(a, _kind(module, name))))
    for name, b in module.named_buffers():
        _set(out["batch_stats"], name, b.detach().float().cpu().numpy().copy())
    return out


def moco_extra_from_flax(key_module: nn.Module,
                         extra: Dict[str, Any]) -> Dict[str, Any]:
    """The port's MoCo `extra` from cmx's: the key encoder's weights loaded
    into `key_module` (in place; its parameters stop requiring grad), the
    queue and pointer as tensors on the module's device."""
    from_flax(key_module, {"params": extra["key_params"],
                           "batch_stats": extra["key_batch_stats"]})
    for p in key_module.parameters():
        p.requires_grad_(False)
    dev = next(key_module.parameters()).device
    queue = np.array(extra["queue"], dtype=np.float32)
    return {"key_model": key_module, "queue": torch.from_numpy(queue).to(dev),
            "queue_ptr": torch.tensor(int(extra["queue_ptr"]),
                                      dtype=torch.int32, device=dev)}


@torch.no_grad()
def moco_extra_to_flax(extra: Dict[str, Any]) -> Dict[str, Any]:
    """cmx's MoCo extra tree (numpy leaves) from the port's."""
    tree = to_flax(extra["key_model"])
    return {"key_params": tree["params"],
            "key_batch_stats": tree["batch_stats"],
            "queue": extra["queue"].detach().float().cpu().numpy().copy(),
            "queue_ptr": np.int32(int(extra["queue_ptr"]))}


def cmunet_extra_from_flax(target_module: nn.Module,
                           extra: Dict[str, Any]) -> Dict[str, Any]:
    """The port's CM-UNet `extra` from cmx's: the target's weights and BN
    stats loaded into `target_module` (in place; its parameters stop
    requiring grad), the reduce kernel as a tensor on its device."""
    from_flax(target_module, {"params": extra["target_params"],
                              "batch_stats": extra["target_batch_stats"]})
    for p in target_module.parameters():
        p.requires_grad_(False)
    dev = next(target_module.parameters()).device
    kernel = np.array(extra["reduce_kernel"], dtype=np.float32)
    return {"target_model": target_module,
            "reduce_kernel": torch.from_numpy(kernel).to(dev)}


@torch.no_grad()
def cmunet_extra_to_flax(extra: Dict[str, Any]) -> Dict[str, Any]:
    """cmx's CM-UNet extra tree (numpy leaves) from the port's."""
    tree = to_flax(extra["target_model"])
    return {"target_params": tree["params"],
            "target_batch_stats": tree["batch_stats"],
            "reduce_kernel": extra["reduce_kernel"].detach().float().cpu()
            .numpy().copy()}


def _extra_state(extra: Any) -> Any:
    if not isinstance(extra, dict):
        return extra
    return {k: v.state_dict() if isinstance(v, nn.Module) else v
            for k, v in extra.items()}


@torch.no_grad()
def _load_extra(extra: Any, saved: Any) -> None:
    if not isinstance(extra, dict):
        return
    if set(saved) != set(extra):
        raise KeyError(f"checkpoint extra has {sorted(saved)}, the task's "
                       f"has {sorted(extra)}")
    for k, v in extra.items():
        if isinstance(v, nn.Module):
            v.load_state_dict(saved[k])
        else:
            v.copy_(saved[k])


class CheckpointManager:
    """Resume checkpoints of a TrainState in `directory` (see the module
    docstring); the newest `max_to_keep` are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        # Best metric persists on disk so a RESUMED run doesn't re-save (and
        # overwrite the historical best) on its first epoch.
        self._best_path = os.path.join(self.directory, "best_metric.json")
        self._best = float("inf")
        if os.path.exists(self._best_path):
            try:
                with open(self._best_path) as f:
                    self._best = float(json.load(f)["best_metric"])
            except (ValueError, KeyError, json.JSONDecodeError):
                pass

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list:
        found = (re.fullmatch(r"step_(\d+)\.pt", f)
                 for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: TrainState,
             metrics: Optional[dict] = None, config: Optional[dict] = None,
             force: bool = False) -> None:
        """Write step `step` (atomically: a temporary file, then a rename;
        an existing file of the step is replaced). `force` is accepted for
        cmx's signature: every save is written."""
        del force
        on_main(self._write, step, state, metrics, config)

    def _write(self, step: int, state: TrainState, metrics: Optional[dict],
               config: Optional[dict]) -> None:
        blob = {"step": int(step), "seed": state.seed,
                "model": state.model.state_dict(),
                "opt": state.opt.state_dict(),
                "extra": _extra_state(state.extra), "metrics": metrics}
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        if config is not None:
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def save_best(self, step: int, state: TrainState, metric: float,
                  **kw) -> bool:
        """Save only when `metric` improves (lower-is-better, like the
        reference's best valid dice_loss gate)."""
        if metric < self._best:
            self._best = metric
            self.save(step, state, metrics={"best_metric": metric}, **kw)
            on_main(self._write_best, metric, step)
            return True
        return False

    def _write_best(self, metric: float, step: int) -> None:
        with open(self._best_path, "w") as f:
            json.dump({"best_metric": metric, "step": step}, f)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load step `step` (the newest by default) into `state` in place
        (model, optimizer, extra, step) and return it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = next(state.model.parameters()).device
        blob = torch.load(self._path(step), map_location=dev,
                          weights_only=True)
        state.model.load_state_dict(blob["model"])
        state.opt.load_state_dict(blob["opt"])
        _load_extra(state.extra, blob["extra"])
        state.step = blob["step"]
        state.seed = blob["seed"]
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing stays open between saves; kept for cmx's interface."""


def _flatten(tree: Dict[str, Any], root: str) -> Dict[str, np.ndarray]:
    """`root/a/b/...` -> leaf, keys sorted as jax.tree_util flattens them."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{root}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def _subtrees(tree: Dict[str, Any], prefix: Optional[str]):
    """cmx's choice of subtree: the `prefix` subtree of params and
    batch_stats where params has it, else the whole trees."""
    params, bs = tree["params"], tree["batch_stats"]
    if prefix is not None and prefix in params:
        return params[prefix], bs.get(prefix, {})
    return params, bs


def export_encoder(state: TrainState, path: str,
                   prefix: Optional[str] = "encoder") -> None:
    """Encoder-only export (the timm_style analog, Spark/utils/misc.py:159-162),
    cmx's format: the `encoder` params + batch_stats subtrees of the state's
    model as a flat .npz (`params/down1/...`, `batch_stats/down1/...`; the
    whole trees when the model has no `encoder`). Rank 0 writes it."""
    on_main(_write_npz, state, path, prefix)


def _write_npz(state: TrainState, path: str, prefix: Optional[str]) -> None:
    params, bs = _subtrees(to_flax(state.model), prefix)
    arrays = {**_flatten(params, "params"), **_flatten(bs, "batch_stats")}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)


def export_model(state: TrainState, path: str) -> None:
    """Whole-model export: ALL params + batch_stats as one flat .npz, as
    cmx's (`params/encoder/down1/...`): enough to rebuild any model for
    inference/vis without optimizer state."""
    export_encoder(state, path, prefix=None)


def write_stamp(encoder_path: str, config: dict, **info) -> str:
    """Provenance stamp for an exported encoder, as cmx's: the full config,
    the encoder's sha256 and size, the creation time and `info` (task,
    corpus, final metrics), written to `<encoder_path>.stamp.json`.

    Returns the stamp path (rank 0 writes it)."""
    path = encoder_path + ".stamp.json"
    on_main(_write_stamp, encoder_path, path, config, info)
    return path


def _write_stamp(encoder_path: str, path: str, config: dict,
                 info: dict) -> None:
    with open(encoder_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    stamp = {
        "encoder_path": os.path.abspath(encoder_path),
        "encoder_sha256": digest,
        "encoder_bytes": os.path.getsize(encoder_path),
        "config": config,
        "created": time.strftime("%F %T"),
        **info,
    }
    with open(path, "w") as f:
        json.dump(stamp, f, indent=2, sort_keys=True)


def _inject(tree: Dict[str, Any], data, root: str) -> None:
    for k, v in tree.items():
        name = f"{root}/{k}"
        if isinstance(v, dict):
            _inject(v, data, name)
        elif name in data.files:
            tree[k] = data[name]


def load_encoder(path: str, module: nn.Module,
                 prefix: Optional[str] = "encoder") -> nn.Module:
    """Load an exported encoder (cmx's or the port's) into `module` in
    place: every name of the file found in the module's `prefix` subtree
    (the whole tree where it has none) replaces that leaf; the rest stay.
    The analog of Finetuning/train.py:load_model (240-308) minus the 5-way
    format sniffing."""
    tree = to_flax(module)
    params, bs = _subtrees(tree, prefix)
    with np.load(path) as data:
        _inject(params, data, "params")
        _inject(bs, data, "batch_stats")
    return from_flax(module, tree)


def load_model_npz(path: str, module: nn.Module) -> nn.Module:
    """Load an `export_model` .npz (cmx's or the port's) into `module`."""
    return load_encoder(path, module, prefix=None)
