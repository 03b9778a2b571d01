"""Weights across the two packages (part of cmx/ckpt/checkpoint.py's role).

cmx's variables are a flax tree {"params": ..., "batch_stats": ...}; the
port keeps flax's names on its parameters and buffers
(`encoder/down1/double_conv/conv0/kernel` <-> `encoder.down1.double_conv.
conv0.kernel`), so the map is mechanical. Layouts that differ:
  * Conv kernels: flax HWIO <-> torch OIHW;
  * ConvTranspose kernels: flax (kh,kw,I,O) <-> torch (I,O,kh,kw) with a
    spatial flip (lax.conv_transpose correlates with the kernel as given;
    torch applies the conv-gradient kernel);
  * mask tokens: flax (1,1,1,C) <-> torch (1,C,1,1).
MoCo's task state crosses the same way: cmx's extra {"key_params",
"key_batch_stats", "queue", "queue_ptr"} <-> the port's {"key_model",
"queue", "queue_ptr"}. Leaves are numpy arrays. orbax checkpoints and the encoder.npz export wait
(ROADMAP: pretrain CLI loop).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from cmx_torch.models.blocks import Conv, ConvTranspose


def _kind(module: nn.Module, name: str) -> str:
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf == "kernel" and isinstance(owner, Conv):
        return "conv"
    if leaf == "kernel" and isinstance(owner, ConvTranspose):
        return "conv_transpose"
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
