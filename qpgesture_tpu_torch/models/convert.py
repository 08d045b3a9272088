"""Carry weights between the JAX parameter trees and the port.

The port's modules use the reference's parameter names (the VQ-VAE's,
Microsoft's WavLM's, fairseq's vq-wav2vec's, Hugging Face BERT's), so
reference checkpoints load with ``load_state_dict``
(``load_vqvae_checkpoint`` here, ``models/wavlm.load_wavlm_checkpoint``,
``models/vq_wav2vec.load_vq_wav2vec_checkpoint``,
``models/minilm.load_minilm``, ``load_pae_checkpoint``,
``load_resync_checkpoint`` and ``load_generator_gru_checkpoint`` here). The
``*_from_jax`` functions are the inverses of the JAX package's converters
(``models/torch_convert.convert_vqvae``, ``convert_pae``,
``convert_resync`` and ``convert_generator_gru``,
``models/wavlm.convert_wavlm``,
``models/vq_wav2vec.convert_vq_wav2vec``, ``models/minilm.convert_minilm``):
they map a flax parameter tree back to a state_dict. The JAX package has
no converter for the resync critic or the FGD extractor: the pairs
``discriminator_state_dict_from_jax`` / ``discriminator_state_dict_to_jax``
and ``fgd_state_dict_from_jax`` / ``fgd_state_dict_to_jax`` carry them both
ways.

Layout facts (the inverse of those in torch_convert):
  * flax conv kernel (k, in, out) -> Conv1d weight (out, in, k);
  * the JAX ConvTranspose1dTorch kernel (k, in, out) is stored flipped
    along k -> ConvTranspose1d weight (in, out, k) after un-flipping;
  * the codebook k -> bottleneck.level_blocks.0.k.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from ..core.config import PAEConfig, VQVAEConfig
from ..device import DeviceLike
from .gru_baseline import GeneratorGRU
from .minilm import MiniLMConfig
from .pae import PAE
from .resync import ResyncNet
from .vq_wav2vec import VQWav2VecConfig
from .vqvae import VQVAE
from .wavlm import WavLMConfig, weight_norm


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _conv1d(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 1, 0))
    out[f"{key}.bias"] = _t(p["bias"])


def _conv_transpose1d(p: Dict, key: str, out: Dict) -> None:
    kernel = np.asarray(p["kernel"])[::-1]            # un-flip along k
    out[f"{key}.weight"] = _t(kernel.transpose(1, 2, 0))
    out[f"{key}.bias"] = _t(p["bias"])


def _resnet(p: Dict, key: str, depth: int, out: Dict) -> None:
    for d in range(depth):
        _conv1d(p[f"block{d}"]["conv1"], f"{key}.model.{d}.model.1", out)
        _conv1d(p[f"block{d}"]["conv2"], f"{key}.model.{d}.model.3", out)


# the codebook's EMA statistics, non-persistent buffers of the port's VQVAE
# that load_state_dict takes when a state_dict carries them
EMA_KEYS = ("bottleneck.level_blocks.0.k_sum",
            "bottleneck.level_blocks.0.k_elem")


def vqvae_state_dict_from_jax(params: Dict, cb,
                              cfg: VQVAEConfig) -> Dict[str, torch.Tensor]:
    """(flax params, codebook with a ``k`` field) -> the port's (and the
    reference's) VQVAE state_dict, as CPU float32 tensors. A codebook that
    also has ``k_sum``/``k_elem`` (a JAX ``CodebookState``, as a train state
    holds it) adds them under EMA_KEYS, so a JAX train state moves into the
    port with its EMA statistics."""
    down_t = cfg.downs_t[0]
    depth = cfg.depth * cfg.hvqvae_multipliers[0]
    sd: Dict[str, torch.Tensor] = {}

    enc = params["encoder"]["level0"]
    enc_base = "encoders.0.level_blocks.0"
    for i in range(down_t):
        _conv1d(enc[f"down{i}_conv"], f"{enc_base}.model.{i}.0", sd)
        _resnet(enc[f"down{i}_resnet"], f"{enc_base}.model.{i}.1", depth, sd)
    _conv1d(enc["proj"], f"{enc_base}.model.{down_t}", sd)

    dec = params["decoder"]["level0"]
    dec_base = "decoders.0.level_blocks.0"
    _conv1d(dec["proj"], f"{dec_base}.model.0", sd)
    for i in range(down_t):
        _resnet(dec[f"up{i}_resnet"], f"{dec_base}.model.{i + 1}.0", depth,
                sd)
        _conv_transpose1d(dec[f"up{i}_convt"], f"{dec_base}.model.{i + 1}.1",
                          sd)
    _conv1d(params["decoder"]["out"], "decoders.0.out", sd)

    sd["bottleneck.level_blocks.0.k"] = _t(cb.k)
    for key, name in zip(EMA_KEYS, ("k_sum", "k_elem")):
        value = getattr(cb, name, None)
        if value is not None:
            sd[key] = _t(value)
    return sd


def _dense(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _layer_norm(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def _batchnorm(p: Dict, st: Dict, key: str, out: Dict) -> None:
    """flax BatchNorm params + batch_stats -> BatchNorm1d tensors;
    ``num_batches_tracked``, which the flax tree does not hold, is 0."""
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(st["mean"])
    out[f"{key}.running_var"] = _t(st["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0)


def pae_state_dict_from_jax(variables: Dict,
                            cfg: PAEConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's PAE variables ({'params', 'batch_stats'}) -> the
    port's (and the reference's) PAE state_dict: the inverse of
    ``convert_pae``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def batchnorm(name: str, key: str) -> None:
        _batchnorm(params[name], stats[name], key, sd)

    _conv1d(params["conv1"], "conv1", sd)
    batchnorm("bn_conv1", "bn_conv1")
    _conv1d(params["conv2"], "conv2", sd)
    batchnorm("bn_conv2", "bn_conv2")
    for i in range(cfg.phase_channels):
        _dense(params[f"fc{i}"], f"fc.{i}", sd)
    for i in range(cfg.phase_channels):
        batchnorm(f"bn{i}", f"bn.{i}")
    _conv1d(params["deconv1"], "deconv1", sd)
    batchnorm("bn_deconv1", "bn_deconv1")
    _conv1d(params["deconv2"], "deconv2", sd)
    return sd


_RESYNC_BLOCKS = [(f"dconv_down{i}", f"down{i}") for i in (1, 2, 3, 4)] + \
    [(f"dconv_up{i}", f"up{i}") for i in (3, 2, 1)]


def resync_state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's ResyncNet variables -> the port's (and the
    reference's) ResyncNet state_dict: the inverse of ``convert_resync``
    (down{i}/up{i} -> dconv_down{i}/dconv_up{i}, conv{0,1} at .0/.3,
    norm{0,1} at .1/.4, last -> conv_last)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for tkey, fkey in _RESYNC_BLOCKS:
        for i, (conv_idx, bn_idx) in enumerate(((0, 1), (3, 4))):
            _conv1d(params[fkey][f"conv{i}"], f"{tkey}.{conv_idx}", sd)
            _batchnorm(params[fkey][f"norm{i}"], stats[fkey][f"norm{i}"],
                       f"{tkey}.{bn_idx}", sd)
    _conv1d(params["last"], "conv_last", sd)
    return sd


def _conv1d_to_jax(sd: Dict, key: str) -> Dict:
    return {"kernel": sd[f"{key}.weight"].detach().cpu().numpy()
            .transpose(2, 1, 0), "bias": sd[f"{key}.bias"].detach().cpu()
            .numpy()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def discriminator_state_dict_from_jax(variables: Dict
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's resync Discriminator parameters (``d1``/``d2``/
    ``d3`` InstanceNorm double convs, ``critic``) -> the port's
    Discriminator state_dict. The critic flattens (B, T/8, 128) time-major
    in JAX and (B, 128, T/8) channel-major here, so its (128 T/8, 1) kernel
    is permuted, not only transposed."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("d1", "d2", "d3"):
        p = params[name]
        for i, (conv_idx, norm_idx) in enumerate(((0, 1), (3, 4))):
            _conv1d(p[f"conv{i}"], f"{name}.{conv_idx}", sd)
            sd[f"{name}.{norm_idx}.weight"] = _t(p[f"in{i}_scale"])
            sd[f"{name}.{norm_idx}.bias"] = _t(p[f"in{i}_bias"])
    kernel = np.asarray(params["critic"]["kernel"])      # (T8 * 128, 1)
    sd["critic.weight"] = _t(kernel.reshape(-1, 128).T.reshape(1, -1))
    return sd


def discriminator_state_dict_to_jax(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of ``discriminator_state_dict_from_jax``: the port's
    Discriminator state_dict -> the JAX package's {"params": ...}."""
    params: Dict = {}
    for name in ("d1", "d2", "d3"):
        p: Dict = {}
        for i, (conv_idx, norm_idx) in enumerate(((0, 1), (3, 4))):
            p[f"conv{i}"] = _conv1d_to_jax(sd, f"{name}.{conv_idx}")
            p[f"in{i}_scale"] = _np(sd[f"{name}.{norm_idx}.weight"])
            p[f"in{i}_bias"] = _np(sd[f"{name}.{norm_idx}.bias"])
        params[name] = p
    weight = _np(sd["critic.weight"])                    # (1, 128 * T8)
    params["critic"] = {"kernel": np.ascontiguousarray(
        weight.reshape(128, -1).T.reshape(-1, 1))}
    return {"params": params}


def fgd_state_dict_from_jax(params: Dict, cfg) -> Dict[str, torch.Tensor]:
    """The JAX package's FGDAutoencoder parameters -> the port's
    FGDAutoencoder state_dict (``render/fgd_extractor``): convs (k, in,
    out) -> (out, in, k); the transposed convs' flax kernels (k, in, out)
    -> (in, out, k) flipped in time (flax's ConvTranspose correlates the
    dilated input with the kernel as stored, torch's with it flipped);
    Dense (in, out) -> Linear (out, in)."""
    params = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.conv_layers):
        _conv1d(params[f"enc{i}"], f"enc{i}", sd)
        _conv_transpose1d(params[f"dec{i}"], f"dec{i}", sd)
    _dense(params["to_latent"], "to_latent", sd)
    _dense(params["from_latent"], "from_latent", sd)
    _conv1d(params["to_pose"], "to_pose", sd)
    return sd


def fgd_state_dict_to_jax(sd: Dict[str, torch.Tensor], cfg) -> Dict:
    """The inverse of ``fgd_state_dict_from_jax``: the port's state_dict ->
    the JAX package's FGDAutoencoder params."""
    params: Dict = {}
    for i in range(cfg.conv_layers):
        params[f"enc{i}"] = _conv1d_to_jax(sd, f"enc{i}")
        params[f"dec{i}"] = {
            "kernel": np.ascontiguousarray(
                _np(sd[f"dec{i}.weight"]).transpose(2, 0, 1)[::-1]),
            "bias": _np(sd[f"dec{i}.bias"])}
    for name in ("to_latent", "from_latent"):
        params[name] = {"kernel": _np(sd[f"{name}.weight"]).T,
                        "bias": _np(sd[f"{name}.bias"])}
    params["to_pose"] = _conv1d_to_jax(sd, "to_pose")
    return params


def generator_gru_state_dict_from_jax(variables: Dict, layers: int = 2
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's GeneratorGRU variables -> the port's (and the
    reference's) Generator_gru state_dict: the inverse of
    ``convert_generator_gru``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    enc, enc_s = params["wav_encoder"], stats["wav_encoder"]
    for i, k in enumerate((0, 3, 6, 9)):
        _conv1d(enc[f"conv{i}"], f"WavEncoder.feat_extractor.{k}", sd)
        _batchnorm(enc[f"bn{i}"], enc_s[f"bn{i}"],
                   f"WavEncoder.feat_extractor.{k + 1}", sd)
    _conv1d(enc["conv4"], "WavEncoder.feat_extractor.12", sd)
    for layer in range(layers):
        for direction, suffix in (("f", ""), ("b", "_reverse")):
            g = params[f"gru{layer}_{direction}"]
            for name in ("ih", "hh"):
                sd[f"project.weight_{name}_l{layer}{suffix}"] = _t(
                    np.asarray(g[f"w_{name}"]).T)
                sd[f"project.bias_{name}_l{layer}{suffix}"] = _t(
                    g[f"b_{name}"])
    _layer_norm(params["norm"], "norm", sd)
    _dense(params["out"], "out", sd)
    return sd


def wavlm_state_dict_from_jax(variables: Dict,
                              cfg: WavLMConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's WavLMJax parameters (numpy leaves; scanned or
    unrolled layers) -> the port's (and Microsoft's) WavLM state_dict: the
    inverse of the JAX package's ``convert_wavlm``. The positional conv
    weight becomes weight_v, with weight_g its own norm, so that
    g / ||v|| * v reproduces it exactly."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_feature_layers)):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.0.weight"] = _t(
            np.asarray(fe[f"conv{i}_kernel"]).transpose(2, 1, 0))
        if cfg.conv_bias:
            sd[f"{base}.0.bias"] = _t(fe[f"conv{i}_bias"])
        if cfg.extractor_mode == "layer_norm":
            _layer_norm(fe[f"ln{i}"], f"{base}.2.1", sd)
        elif i == 0:
            sd[f"{base}.2.weight"] = _t(fe["gn_scale"])
            sd[f"{base}.2.bias"] = _t(fe["gn_bias"])
    _layer_norm(params["feat_layer_norm"], "layer_norm", sd)
    if "post_extract_proj" in params:
        _dense(params["post_extract_proj"], "post_extract_proj", sd)

    v = _t(np.asarray(params["pos_conv_kernel"]).transpose(2, 1, 0))
    sd["encoder.pos_conv.0.weight_g"] = weight_norm(v)
    sd["encoder.pos_conv.0.weight_v"] = v
    sd["encoder.pos_conv.0.bias"] = _t(params["pos_conv_bias"])
    _layer_norm(params["encoder_layer_norm"], "encoder.layer_norm", sd)

    if "layers_scan" in params:
        stacked = params["layers_scan"]["layer"]
        layers = [params["layer0"]] + [
            _tree_index(stacked, i) for i in range(cfg.encoder_layers - 1)]
    else:
        layers = [params[f"layer{i}"] for i in range(cfg.encoder_layers)]
    for i, layer in enumerate(layers):
        base = f"encoder.layers.{i}"
        attn = layer["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense(attn[name], f"{base}.self_attn.{name}", sd)
        if cfg.gru_rel_pos:
            _dense(attn["grep_linear"], f"{base}.self_attn.grep_linear", sd)
            sd[f"{base}.self_attn.grep_a"] = _t(attn["grep_a"])
        if i == 0 and cfg.relative_position_embedding:
            sd[f"{base}.self_attn.relative_attention_bias.weight"] = _t(
                attn["rel_bias"])
        _layer_norm(layer["self_attn_layer_norm"],
                    f"{base}.self_attn_layer_norm", sd)
        _layer_norm(layer["final_layer_norm"], f"{base}.final_layer_norm",
                    sd)
        _dense(layer["fc1"], f"{base}.fc1", sd)
        _dense(layer["fc2"], f"{base}.fc2", sd)
    return sd


def vq_wav2vec_state_dict_from_jax(variables: Dict, cfg: VQWav2VecConfig
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's VQWav2Vec parameters (numpy leaves) -> the port's
    (and fairseq's) state_dict: the inverse of ``convert_vq_wav2vec`` for
    the nested weight_proj layout."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_layers)):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.0.weight"] = _t(
            np.asarray(fe[f"conv{i}_kernel"]).transpose(2, 1, 0))
        sd[f"{base}.2.weight"] = _t(fe[f"gn{i}_scale"])
        sd[f"{base}.2.bias"] = _t(fe[f"gn{i}_bias"])
    vq = params["vector_quantizer"]
    pre = "vector_quantizer.weight_proj"
    depth = cfg.weight_proj_depth
    if depth > 1:
        for d in range(depth - 1):
            _dense(vq[f"proj{d}"], f"{pre}.{d}.0", sd)
        _dense(vq["proj_out"], f"{pre}.{depth - 1}", sd)
    else:
        _dense(vq["proj_out"], pre, sd)
    return sd


def minilm_state_dict_from_jax(variables: Dict, cfg: MiniLMConfig
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's MiniLMJax parameters (numpy leaves) -> the port's
    (and Hugging Face BertModel's) state_dict, without the pooler: the
    inverse of ``convert_minilm``."""
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for name in ("word", "position", "token_type"):
        sd[f"embeddings.{name}_embeddings.weight"] = _t(
            params[f"{name}_embeddings"])
    _layer_norm(params["embed_ln"], "embeddings.LayerNorm", sd)
    for i in range(cfg.num_layers):
        p, base = params[f"layer{i}"], f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _dense(p["self_attn"][name], f"{base}.attention.self.{name}", sd)
        _dense(p["attn_output"], f"{base}.attention.output.dense", sd)
        _layer_norm(p["attn_ln"], f"{base}.attention.output.LayerNorm", sd)
        _dense(p["intermediate"], f"{base}.intermediate.dense", sd)
        _dense(p["output"], f"{base}.output.dense", sd)
        _layer_norm(p["output_ln"], f"{base}.output.LayerNorm", sd)
    return sd


def _tree_index(tree, i: int):
    """Entry i along the leading axis of every leaf of a nested dict."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def strip_prefix(state_dict: Dict, prefix: str = "module.") -> Dict:
    """Remove nn.DataParallel's 'module.' wrapper prefix."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v
            for k, v in state_dict.items()}


def _torch_load_reference(path: str):
    """torch.load for reference checkpoints, tolerant of the pickled
    EasyDict config: the reference saves {'args': EasyDict, 'epoch',
    'model_dict'} (train.py:114-116), and unpickling the args needs the
    easydict package, so an equivalent shim module stands in when it is
    missing."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        if "easydict" not in str(e):
            raise
        import sys
        import types

        class EasyDict(dict):
            def __getattr__(self, k):
                try:
                    return self[k]
                except KeyError:
                    raise AttributeError(k)

            def __setattr__(self, k, v):
                self[k] = v

        mod = types.ModuleType("easydict")
        mod.EasyDict = EasyDict
        sys.modules["easydict"] = mod
        try:
            return torch.load(path, map_location="cpu", weights_only=False)
        finally:
            sys.modules.pop("easydict", None)


def load_vqvae_checkpoint(path: str, cfg: VQVAEConfig,
                          device: DeviceLike = "cuda") -> VQVAE:
    """A port VQVAE from a reference .bin/.pt checkpoint, or from a
    ``train-vqvae`` output directory, whose ``best.pt`` it reads (as the JAX
    package reads ``best``), EMA statistics included. Keys the port does
    not hold are ignored; a key the port needs and the checkpoint lacks
    raises."""
    if os.path.isdir(path):
        from ..train.checkpoints import restore_checkpoint
        sd = restore_checkpoint(path, "best")["model_dict"]
    else:
        ckpt = _torch_load_reference(path)
        sd = strip_prefix(ckpt["model_dict"] if "model_dict" in ckpt
                          else ckpt)
    model = VQVAE(cfg, device=device)
    wanted = list(model.state_dict().keys())
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} VQ-VAE "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted + list(EMA_KEYS)
                           if k in sd})
    return model


def load_pae_checkpoint(path: str, cfg: PAEConfig,
                        device: DeviceLike = "cuda") -> PAE:
    """Load a reference PAE checkpoint ({'model_dict': sd} or a bare sd,
    with or without the DataParallel 'module.' prefix) into a port PAE."""
    ckpt = _torch_load_reference(path)
    sd = strip_prefix(ckpt["model_dict"] if "model_dict" in ckpt else ckpt)
    model = PAE(cfg, device=device)
    model.load_state_dict(sd)
    return model


def _load_reference_state_dict(path: str, key: str) -> Dict:
    """The state_dict of a reference torch checkpoint file: the ``key``
    entry of the pickled dict, or a bare state_dict, without the
    DataParallel prefix. A directory is a trainer's output: the ``key``
    entry of the port's own checkpoint ``<path>/latest.pt`` (an orbax
    directory of the JAX package's trainers raises there, naming what it
    holds)."""
    if os.path.isdir(path):
        from ..train.checkpoints import restore_checkpoint
        return restore_checkpoint(path, "latest")[key]
    ckpt = _torch_load_reference(path)
    return strip_prefix(ckpt.get(key, ckpt))


def load_resync_checkpoint(path: str, device: DeviceLike = "cuda"
                           ) -> ResyncNet:
    """A reference ResyncNet checkpoint ({'model_resync_state_dict': sd},
    train_resync_gestureknn.save_model, or a bare sd), or a ``train-resync``
    output directory, whose ``latest.pt`` it reads (the generator under the
    same key), as a port ResyncNet in eval mode; its in/out widths are read
    off the weights."""
    sd = _load_reference_state_dict(path, "model_resync_state_dict")
    model = ResyncNet(in_features=sd["dconv_down1.0.weight"].shape[1],
                      out_features=sd["conv_last.weight"].shape[0],
                      device=device)
    model.load_state_dict(sd)
    return model.eval()


def load_generator_gru_checkpoint(path: str, device: DeviceLike = "cuda"
                                  ) -> GeneratorGRU:
    """A reference Generator_gru checkpoint ({'model_dict': sd},
    end2end.py:119-128, or a bare sd), or a ``train-end2end`` output
    directory, whose ``latest.pt`` it reads (as the JAX package reads
    ``latest``), as a port GeneratorGRU in eval mode; its hidden and output
    widths are read off the weights."""
    sd = _load_reference_state_dict(path, "model_dict")
    model = GeneratorGRU(hidden=sd["project.weight_hh_l0"].shape[1],
                         output=sd["out.weight"].shape[0], device=device)
    model.load_state_dict(sd)
    model.project.flatten_parameters()
    return model.eval()
