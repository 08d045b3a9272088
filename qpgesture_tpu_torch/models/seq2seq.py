"""Legacy text -> pose Seq2Seq attention network.

The port of the JAX package's ``models/seq2seq.py`` (the reference's
codebook/generate/generate.py:69-309: EncoderRNN, Attn,
BahdanauAttnDecoderRNN, Generator, Seq2SeqNet, a Yoon-et-al-lineage
text-to-gesture baseline that nothing in the reference constructs). Module
and parameter names are the reference's, so the state_dict that the JAX
package's ``torch_convert.convert_seq2seq`` reads loads here with
``load_state_dict``: ``encoder.embedding``, ``encoder.gru`` (bidirectional,
``n_layers``), ``decoder.decoder.{attn.attn, attn.v, pre_linear.0 (Linear),
pre_linear.1 (BatchNorm1d), gru, out}``.

Semantics kept from the reference (and the JAX package):

* the encoder's GRU runs over a packed sequence: hidden states stop past
  each sequence's length, pad outputs are zero, the backward direction
  starts at each sequence's last valid token; the two directions are
  summed;
* the attention softmaxes ``v . tanh(W [h; enc_t])`` over all T encoder
  steps, pads included (the reference masks nothing);
* a decoder step: attention context + the previous pose -> pre_linear
  (Linear -> BatchNorm1d -> ReLU) -> ``n_layers`` GRU layers -> Linear;
* the decoder starts from the first ``n_layers`` entries of the encoder's
  interleaved hidden stack ``[l0_f, l0_b, l1_f, l1_b, ...]``;
* the first ``n_pre_poses`` frames are teacher-forced, the rest fed back;
  output frame 0 is the seed pose.

In training the BatchNorm is flax's (``models/batchnorm``: biased batch
variance, momentum 0.9 in flax's terms) and advances its running
statistics once per decoder step, as the JAX package's ``variable_carry``
scan does; dropout between GRU layers draws its masks from the caller's
``torch.Generator``. The GRUs run a layer at a time through torch's fused
GRU (cuDNN on the card); everything is float32 with TF32 off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..device import DeviceLike, resolve_device
from .batchnorm import BatchNorm1d


def _dropout(x: torch.Tensor, p: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


def _gru_layer(gru: nn.GRU, layer: int, x, h0, batch_sizes=None):
    """Layer ``layer`` of ``gru`` (both directions when bidirectional) over
    x (time-major (T, B, D), or packed data with ``batch_sizes``) from h0
    (dirs, B, H). Returns (output, h_n). cuDNN keeps what a backward pass
    needs only when asked (``train``): whenever autograd records."""
    per_layer = len(gru._flat_weights) // gru.num_layers
    weights = gru._flat_weights[layer * per_layer:(layer + 1) * per_layer]
    train = torch.is_grad_enabled()
    if batch_sizes is None:
        return torch._VF.gru(x, h0, weights, gru.bias, 1, 0.0, train,
                             gru.bidirectional, False)
    return torch._VF.gru(x, batch_sizes, h0, weights, gru.bias, 1, 0.0,
                         train, gru.bidirectional)


class EncoderRNN(nn.Module):
    """Word embedding -> ``n_layers`` bidirectional GRU over the packed
    tokens; directions summed (generate.py:70-113)."""

    def __init__(self, vocab: int, embed: int, hidden: int,
                 n_layers: int = 1, dropout: float = 0.5):
        super().__init__()
        self.hidden = hidden
        self.dropout = dropout
        self.embedding = nn.Embedding(vocab, embed)
        self.gru = nn.GRU(embed, hidden, n_layers, bidirectional=True,
                          dropout=dropout if n_layers > 1 else 0.0)

    def forward(self, tokens: torch.Tensor, lengths,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, T) int, lengths (B,) -> (outputs (B, T, H) with zero
        pads, hidden (2 * n_layers, B, H) ordered [l0_f, l0_b, ...])."""
        B, T = tokens.shape
        lengths = torch.as_tensor(lengths).cpu().long()
        packed = pack_padded_sequence(self.embedding(tokens.long()), lengths,
                                      batch_first=True, enforce_sorted=False)
        data, hiddens = packed.data, []
        for layer in range(self.gru.num_layers):
            h0 = data.new_zeros(2, B, self.hidden)
            data, h_n = _gru_layer(self.gru, layer, data, h0,
                                   packed.batch_sizes)
            hiddens.append(h_n)
            if self.training and layer < self.gru.num_layers - 1 \
                    and self.dropout > 0:
                data = _dropout(data, self.dropout, generator)
        out, _ = pad_packed_sequence(
            packed._replace(data=data), batch_first=True, total_length=T)
        # h_n follows the packed (sorted) order of the batch
        hidden = torch.cat(hiddens).index_select(
            1, packed.unsorted_indices.to(data.device))
        return out[..., :self.hidden] + out[..., self.hidden:], hidden


class Attn(nn.Module):
    """softmax_t(v . tanh(W [h; enc_t])) over all T (generate.py:116-144)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.attn = nn.Linear(2 * hidden, hidden)
        self.v = nn.Parameter(torch.randn(hidden) / hidden ** 0.5)

    def forward(self, h: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        hT = h[:, None, :].expand_as(enc)
        energy = torch.tanh(self.attn(torch.cat((hT, enc), -1)))
        return F.softmax(energy @ self.v, dim=1)             # (B, T)


class BahdanauAttnDecoderRNN(nn.Module):
    """One decoder step (generate.py:196-243)."""

    def __init__(self, input_size: int, hidden: int, output: int,
                 n_layers: int = 1, dropout_p: float = 0.1):
        super().__init__()
        self.dropout_p = dropout_p
        self.attn = Attn(hidden)
        self.pre_linear = nn.Sequential(
            nn.Linear(input_size + hidden, hidden), BatchNorm1d(hidden),
            nn.ReLU())
        self.gru = nn.GRU(hidden, hidden, n_layers,
                          dropout=dropout_p if n_layers > 1 else 0.0)
        self.out = nn.Linear(hidden, output)

    def forward(self, motion: torch.Tensor, last_hidden: torch.Tensor,
                enc: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """(B, pose) previous pose, (n_layers, B, H) hidden, (B, T, H)
        encoder outputs -> ((B, pose) output, (n_layers, B, H) hidden,
        (B, T) attention weights)."""
        w = self.attn(last_hidden[-1], enc)
        context = torch.einsum("bt,bth->bh", w, enc)
        x = self.pre_linear(torch.cat((motion, context), -1))[None]
        hidden = []
        for layer in range(self.gru.num_layers):
            x, h = _gru_layer(self.gru, layer, x,
                              last_hidden[layer:layer + 1].contiguous())
            hidden.append(h)
            if self.training and layer < self.gru.num_layers - 1 \
                    and self.dropout_p > 0:
                x = _dropout(x, self.dropout_p, generator)
        return self.out(x[0]), torch.cat(hidden), w


class Generator(nn.Module):
    """The reference's Generator, the wrapper that holds the decoder step
    (its keys start ``decoder.decoder``)."""

    def __init__(self, hidden: int, pose_dim: int, n_layers: int,
                 dropout: float):
        super().__init__()
        self.decoder = BahdanauAttnDecoderRNN(pose_dim, hidden, pose_dim,
                                              n_layers, dropout)

    def forward(self, motion, last_hidden, enc, generator=None):
        return self.decoder(motion, last_hidden, enc, generator)


class Seq2SeqNet(nn.Module):
    """Text -> pose sequence (generate.py:275-309). ``forward(tokens,
    lengths, poses)`` returns (B, n_frames, pose_dim): frame 0 is
    ``poses[:, 0]``, frame t the decoder's output at step t, fed the ground
    truth pose t while t < n_pre_poses and its own output after."""

    def __init__(self, vocab: int, embed: int, hidden: int, pose_dim: int,
                 n_frames: int, n_pre_poses: int = 10, n_layers: int = 1,
                 dropout: float = 0.1, device: DeviceLike = "cuda"):
        super().__init__()
        self.n_frames = n_frames
        self.n_pre_poses = n_pre_poses
        self.n_layers = n_layers
        self.encoder = EncoderRNN(vocab, embed, hidden, n_layers, dropout)
        self.decoder = Generator(hidden, pose_dim, n_layers, dropout)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.decoder.decoder.out.weight.device

    def forward(self, tokens: torch.Tensor, lengths, poses: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        enc_out, enc_hidden = self.encoder(tokens, lengths, generator)
        hidden = enc_hidden[:self.n_layers]
        prev, outs = poses[:, 0], [poses[:, 0]]
        for t in range(1, self.n_frames):
            out, hidden, _ = self.decoder(prev, hidden, enc_out, generator)
            outs.append(out)
            prev = poses[:, t] if t < self.n_pre_poses else out
        return torch.stack(outs, dim=1)
