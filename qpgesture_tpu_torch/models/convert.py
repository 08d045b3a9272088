"""Carry weights between the JAX parameter trees and the port.

The port's modules use the reference's parameter names (the VQ-VAE's,
Microsoft's WavLM's, fairseq's vq-wav2vec's, Hugging Face BERT's), so
reference checkpoints load with ``load_state_dict``
(``load_vqvae_checkpoint`` here, ``models/wavlm.load_wavlm_checkpoint``,
``models/vq_wav2vec.load_vq_wav2vec_checkpoint``,
``models/minilm.load_minilm``, ``load_pae_checkpoint`` here). The
``*_from_jax`` functions are the inverses of the JAX package's converters
(``models/torch_convert.convert_vqvae`` and ``convert_pae``,
``models/wavlm.convert_wavlm``,
``models/vq_wav2vec.convert_vq_wav2vec``, ``models/minilm.convert_minilm``):
they map a flax parameter tree back to a state_dict.

Layout facts (the inverse of those in torch_convert):
  * flax conv kernel (k, in, out) -> Conv1d weight (out, in, k);
  * the JAX ConvTranspose1dTorch kernel (k, in, out) is stored flipped
    along k -> ConvTranspose1d weight (in, out, k) after un-flipping;
  * the codebook k -> bottleneck.level_blocks.0.k.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.config import PAEConfig, VQVAEConfig
from ..device import DeviceLike
from .minilm import MiniLMConfig
from .pae import PAE
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


def vqvae_state_dict_from_jax(params: Dict, cb,
                              cfg: VQVAEConfig) -> Dict[str, torch.Tensor]:
    """(flax params, codebook with a ``k`` field) -> the port's (and the
    reference's) VQVAE state_dict, as CPU float32 tensors."""
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
    return sd


def _dense(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _layer_norm(p: Dict, key: str, out: Dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def pae_state_dict_from_jax(variables: Dict,
                            cfg: PAEConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's PAE variables ({'params', 'batch_stats'}) -> the
    port's (and the reference's) PAE state_dict: the inverse of
    ``convert_pae``. BatchNorm's ``num_batches_tracked``, which the flax
    tree does not hold, is 0."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def batchnorm(name: str, key: str) -> None:
        sd[f"{key}.weight"] = _t(params[name]["scale"])
        sd[f"{key}.bias"] = _t(params[name]["bias"])
        sd[f"{key}.running_mean"] = _t(stats[name]["mean"])
        sd[f"{key}.running_var"] = _t(stats[name]["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

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
    """Load a reference .bin/.pt checkpoint into a port VQVAE. Keys the port
    does not hold (the reference's EMA statistics buffers) are ignored; a
    key the port needs and the checkpoint lacks raises."""
    ckpt = _torch_load_reference(path)
    sd = strip_prefix(ckpt["model_dict"] if "model_dict" in ckpt else ckpt)
    model = VQVAE(cfg, device=device)
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {len(missing)} VQ-VAE "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted})
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
