from .convert import load_vqvae_checkpoint, vqvae_state_dict_from_jax
from .vqvae import VQVAE

__all__ = ["VQVAE", "load_vqvae_checkpoint", "vqvae_state_dict_from_jax"]
