"""Checkpoints of the port, counterpart of ``rangedet_tpu/train/checkpoint.py``
(reference epoch-end save / load, utils/callback.py:102-106,
utils/load_model.py:5-51).

A checkpoint is one ``torch.save`` file holding the model's ``state_dict``
(parameters and BatchNorm running statistics), the optimizer's (SGD's
momentum buffers, or AdamW's moments and step counts), the step count and
the epoch. The JAX package's checkpoints are
orbax directories, which the port cannot read; ``convert.load_npz`` is the
bridge for JAX weights. Both may share one experiment directory: the port
names its files ``torch_epoch_NNNN.pt`` beside orbax's ``epoch_NNNN``, and
each ``latest_epoch`` counts only its own.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple, Union

import torch

from .state import TrainState

_NAME = re.compile(r"^torch_epoch_(\d+)\.pt$")


def checkpoint_dir(cfg) -> str:
    return os.path.abspath(os.path.join(cfg.experiment_dir, cfg.name,
                                        "checkpoints"))


def checkpoint_path(cfg, epoch: int) -> str:
    return os.path.join(checkpoint_dir(cfg), f"torch_epoch_{epoch:04d}.pt")


def save_checkpoint(state: TrainState, cfg, epoch: int) -> str:
    """Write the checkpoint of ``epoch`` (0-based, as the JAX package
    counts) atomically. Returns its path."""
    path = checkpoint_path(cfg, epoch)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "epoch": epoch}, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(cfg) -> Optional[int]:
    """The highest epoch with a checkpoint of the port, or None."""
    path = checkpoint_dir(cfg)
    if not os.path.isdir(path):
        return None
    epochs = [int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
              if m]
    return max(epochs) if epochs else None


def restore_checkpoint(target: Union[TrainState, torch.nn.Module], cfg,
                       epoch: Optional[int] = None
                       ) -> Tuple[Union[TrainState, torch.nn.Module],
                                  Optional[int]]:
    """Load the checkpoint of ``epoch`` (default: the latest) into
    ``target`` in place: a TrainState gets the model, the optimizer and
    the step; a bare model its state_dict. Returns (target, epoch), or
    (target, None) when there is no checkpoint. The file is read to the
    host; loading puts each tensor where the target's lives, and leaves
    AdamW's step counts on the host, as a fresh optimizer keeps them (one
    on the card would cost a wait a parameter and step)."""
    if epoch is None:
        epoch = latest_epoch(cfg)
    if epoch is None:
        return target, None
    model = target.model if isinstance(target, TrainState) else target
    ckpt = torch.load(checkpoint_path(cfg, epoch), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(ckpt["model"], strict=True)
    if isinstance(target, TrainState):
        target.optimizer.load_state_dict(ckpt["optimizer"])
        target.step = int(ckpt["step"])
    return target, epoch
