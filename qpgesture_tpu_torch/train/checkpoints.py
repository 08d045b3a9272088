"""The trainers' checkpoints: one ``torch.save`` dict per name.

The JAX package writes an orbax directory per name (``best``, ``latest``,
``{epoch:03d}``) holding params, optimizer state, the EMA codebook and the
update count; the port writes ``<directory>/<name>.pt`` with the same
content: the model's state_dict under the reference's names (so
``load_state_dict`` takes it, and the reference's loaders read the file),
the codebook's ``k_sum``/``k_elem`` where there is one, the optimizer
state, the update count and the epoch. Reading uses
``torch.load(weights_only=True)``: no pickled code runs.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def checkpoint_path(directory: str, name: str = "latest") -> str:
    return os.path.join(directory, f"{name}.pt")


def save_checkpoint(directory: str, state: Dict[str, Any],
                    name: str = "latest") -> str:
    """Write ``state`` to <directory>/<name>.pt (through a temporary file,
    so a reader never sees half a checkpoint). Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, name)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(directory: str, name: str = "latest",
                       map_location: Any = "cpu") -> Dict[str, Any]:
    """The dict saved as <directory>/<name>.pt. A directory without it (an
    orbax checkpoint of the JAX package's trainers, say) raises, naming what
    the directory holds."""
    path = checkpoint_path(directory, name)
    if not os.path.isfile(path):
        found = sorted(os.listdir(directory)) if os.path.isdir(directory) \
            else None
        raise FileNotFoundError(
            f"no {name}.pt in {directory} (found: {found}); the port reads "
            "the checkpoints its own trainers write, not orbax directories")
    return torch.load(path, map_location=map_location, weights_only=True)


class Checkpointed:
    """The checkpoint dict of a trainer: the state_dict of each module and
    optimizer it owns, under the keys that ``MODULES`` and ``OPTIMIZERS``
    map to its attributes, with the update count ``step`` and the epoch."""

    MODULES = {"model_dict": "model"}
    OPTIMIZERS = {"optimizer": "opt"}

    def module_state(self, attr: str) -> Dict[str, torch.Tensor]:
        return dict(getattr(self, attr).state_dict())

    def state_dict(self, epoch: int = 0) -> Dict[str, Any]:
        state = {key: self.module_state(attr)
                 for key, attr in self.MODULES.items()}
        state.update({key: getattr(self, attr).state_dict()
                      for key, attr in self.OPTIMIZERS.items()})
        state.update(step=self.step, epoch=epoch)
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` (on any device). Adam's step counts stay
        on the host, where torch keeps them for a non-capturable optimizer: a
        count restored onto the card would make every later update read it
        back."""
        for key, attr in self.MODULES.items():
            getattr(self, attr).load_state_dict(state[key])
        for key, attr in self.OPTIMIZERS.items():
            opt = getattr(self, attr)
            opt.load_state_dict(state[key])
            for st in opt.state.values():
                if isinstance(st.get("step"), torch.Tensor):
                    st["step"] = st["step"].cpu()
        self.step = int(state["step"])
