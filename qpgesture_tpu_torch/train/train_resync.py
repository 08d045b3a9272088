"""ResyncNet WGAN-GP trainer on one GPU.

Mirrors Speech2GestureMatching/train_resync_gestureknn.py:38-187 as the JAX
package's ``train/train_resync.py`` does: the critic trains every iteration
on (mfcc | motion) stacks with the gradient penalty (lambda 100); the UNet
generator trains every ``gen_hop`` iterations (``it % gen_hop == 0``) with
adversarial weight ``weight_gen`` and an L1 reconstruction, weighted
``weight_recon``, against the KNN *input* motion (the generator resyncs the
matched motion; ground truth feeds only the critic). Both networks take
torch's Adam(lr, betas (0.0, 0.9), weight_decay 4e-5): coupled L2, the
decay added to the gradient before the moments, as optax's
``add_decayed_weights`` -> ``scale_by_adam`` chain does.

The critic step generates its fakes with the generator in training mode
(batch statistics, running statistics advancing) under ``no_grad``, as the
reference and the JAX package do; the generator step then starts from the
statistics that step left. The interpolation points of the penalty are
drawn for the whole batch from the trainer's ``torch.Generator`` on its
device. A step reads nothing back to the host: the losses stay device
tensors and Adam's step counts stay on the host. The steps run under
``device.cudnn_autotune``. One device: a ``mesh_shape`` of more than one
device raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.config import ResyncConfig
from ..device import DeviceLike, cudnn_autotune, resolve_device, to_device
from ..models.resync import Discriminator, ResyncNet, gradient_penalty
from .checkpoints import Checkpointed
from .train_vqvae import check_one_device, seeded_init


class ResyncTrainer(Checkpointed):
    """Owns the generator ``gen`` and the critic ``disc`` (on ``device``),
    one Adam each, the critic-update count ``step`` and the generator that
    draws the penalty's interpolation points. Inputs are (B, T, n_mfcc +
    n_joints) in the JAX package's layout; the networks run in the
    reference's NCT layout."""

    MODULES = {"model_resync_state_dict": "gen",
               "model_disc_state_dict": "disc"}
    OPTIMIZERS = {"optimizer_resync": "g_opt", "optimizer_disc": "d_opt"}

    def __init__(self, cfg: ResyncConfig, n_mfcc: int, n_joints: int,
                 num_frames: int, mesh_shape: Optional[Sequence[int]] = None,
                 device: DeviceLike = "cuda", seed: int = 0):
        check_one_device(mesh_shape)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_mfcc = n_mfcc
        channels = n_mfcc + n_joints
        self.gen = seeded_init(lambda: ResyncNet(
            channels, n_joints, device="cpu"), seed).to(self.device)
        self.disc = seeded_init(lambda: Discriminator(
            channels, num_frames, device="cpu"), seed + 1).to(self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed + 2)

        def adam(module):
            return torch.optim.Adam(module.parameters(), lr=cfg.lr,
                                    betas=tuple(cfg.betas), eps=1e-8,
                                    weight_decay=cfg.weight_decay)

        self.g_opt = adam(self.gen)
        self.d_opt = adam(self.disc)
        self.step = 0

    def _inputs(self, x_knn, x_real):
        """(B, T, C) host or device arrays -> (B, C, T) tensors on the
        device."""
        return tuple(to_device(x, self.device, torch.float32).transpose(1, 2)
                     for x in (x_knn, x_real))

    def draw_eps(self, batch: int) -> torch.Tensor:
        """The penalty's interpolation points for a batch, (B, 1, 1)."""
        return torch.rand((batch, 1, 1), generator=self.generator,
                          device=self.device)

    def d_step(self, x_knn, x_real, eps: torch.Tensor) -> torch.Tensor:
        """One critic update: mean(D(fake)) - mean(D(real)) + lambda * gp.
        Returns the loss as a device tensor; the critic's ``.grad`` hold this
        step's gradients afterwards."""
        knn, real = self._inputs(x_knn, x_real)
        self.gen.train()
        with cudnn_autotune():
            with torch.no_grad():
                fake = torch.cat((knn[:, :self.n_mfcc], self.gen(knn)), 1)
            loss = self.disc(fake).mean() - self.disc(real).mean() + \
                self.cfg.lambda_gp * gradient_penalty(
                    self.disc, real, fake, eps.to(self.device).view(-1, 1, 1))
            params = list(self.disc.parameters())
            grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        self.d_opt.step()
        self.step += 1
        return loss.detach()

    def g_step(self, x_knn, x_real) -> torch.Tensor:
        """One generator update: weight_gen * -mean(D(fake)) + weight_recon
        * L1(motion, knn motion). Returns the loss as a device tensor; the
        generator's ``.grad`` hold this step's gradients afterwards."""
        knn, _ = self._inputs(x_knn, x_real)
        self.gen.train()
        with cudnn_autotune():
            motion = self.gen(knn)
            fake = torch.cat((knn[:, :self.n_mfcc], motion), 1)
            loss = self.cfg.weight_gen * -self.disc(fake).mean() + \
                self.cfg.weight_recon * F.l1_loss(motion,
                                                  knn[:, self.n_mfcc:])
            params = list(self.gen.parameters())
            grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        self.g_opt.step()
        return loss.detach()

    def train_iteration(self, x_knn, x_real, it: int,
                        eps: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
        """One reference iteration: the critic always, the generator when
        ``it % gen_hop == 0``. ``eps`` defaults to a draw from the trainer's
        generator. Returns {"d_loss"[, "g_loss"]} as device tensors."""
        if eps is None:
            eps = self.draw_eps(x_knn.shape[0])
        logs = {"d_loss": self.d_step(x_knn, x_real, eps)}
        if it % self.cfg.gen_hop == 0:
            logs["g_loss"] = self.g_step(x_knn, x_real)
        return logs
