"""Checkpoints and model exports (port of ``tpupose/train/checkpoint.py``).

* ``save_checkpoint`` writes the full train state (step, model and
  optimizer state dicts) to ``<out>/ckpt/<step>/state.pt`` with
  ``torch.save``; ``restore_checkpoint`` reads it back with
  ``weights_only=True`` into an initialised state (``--resume``).
* ``export_model_npz`` writes the model alone as a Chainer-compatible
  ``.npz`` (``model_iter_<step>.npz``) in the keys the JAX package's
  ``save_npz_params`` writes, so either package loads the other's files.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from tpupose_torch.train.trainer import TrainState
from tpupose_torch.weights import save_chainer_npz

_STATE_FILE = "state.pt"


def save_checkpoint(out_dir: str, state: TrainState) -> str:
    """Write a full train-state snapshot; returns its directory."""
    path = os.path.abspath(os.path.join(out_dir, "ckpt", str(state.step)))
    os.makedirs(path, exist_ok=True)
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()},
               os.path.join(path, _STATE_FILE))
    return path


def latest_checkpoint(out_dir: str) -> Optional[str]:
    """The snapshot directory of the highest step under ``<out>/ckpt``."""
    root = os.path.join(out_dir, "ckpt")
    if not os.path.isdir(root):
        return None
    steps = [int(d) for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, str(max(steps)))


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a snapshot written by ``save_checkpoint`` into ``state`` (an
    initialised state of the same arch) in place, on its model's
    device."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, _STATE_FILE), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def export_model_npz(out_dir: str, state: TrainState,
                     name: Optional[str] = None) -> str:
    """Model-only export, ``model_iter_<step>.npz`` by default."""
    name = name or f"model_iter_{state.step}.npz"
    path = os.path.join(out_dir, name)
    os.makedirs(out_dir, exist_ok=True)
    save_chainer_npz(path, state.model)
    return path
