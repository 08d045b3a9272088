"""MiniLM sentence encoder (inference path), as PyTorch modules.

The port of ``qpgesture_tpu/models/minilm.py``. The reference embeds each
code slot's context text with sentence-transformers
``paraphrase-MiniLM-L6-v2`` (make_beat_dataset.py:446-447): a 6-layer,
384-wide BERT encoder followed by attention-mask mean pooling (the
paraphrase-* family has no output normalisation):

  * BertEmbeddings: word + learned absolute position + token-type
    embeddings, LayerNorm (eps 1e-12);
  * post-LN layers: self-attention with an additive -1e9 key mask, the
    attention-output LayerNorm, an erf-GELU FFN, the output LayerNorm;
  * mean pooling over the attention mask (SentenceTransformer's
    Pooling(mean)).

The modules carry Hugging Face BERT's parameter names, so a
sentence-transformers or BERT checkpoint loads with ``load_state_dict``
(``load_minilm``; the ``0.auto_model.`` and ``bert.`` prefixes are
stripped, as the JAX package's ``convert_minilm`` does). Everything runs in
float32 with TF32 off: the embeddings feed cosine ranks. A host WordPiece
tokenizer (``WordPieceTokenizer``) reproduces HF's BertTokenizer, so the
text path needs neither transformers nor sentence-transformers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device, to_device


@dataclass(frozen=True)
class MiniLMConfig:
    """paraphrase-MiniLM-L6-v2 defaults (a BERT-architecture encoder)."""
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    max_seq_length: int = 128       # sentence-transformers truncation


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        D = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, D)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                D)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, D)
        self.LayerNorm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        T = input_ids.shape[1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings.weight[:T][None]
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(D, D)
        self.value = nn.Linear(D, D)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (B, T, D); mask: (B, T), 1 = real token."""
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H
        q = self.query(x).view(B, T, H, hd)
        k = self.key(x).view(B, T, H, hd)
        v = self.value(x).view(B, T, H, hd)
        scores = torch.einsum("bthd,bshd->bhts", q * hd ** -0.5, k)
        # additive key mask (get_extended_attention_mask): masked keys get
        # -1e9; every query row keeps at least one live key ([CLS])
        scores = scores + torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        attn = torch.softmax(scores, dim=-1)
        return torch.einsum("bhts,bshd->bthd", attn, v).reshape(B, T, D)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertAttention(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.output.dense(self.self(x, mask))
        return self.output.LayerNorm(x + h)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertOutput(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutput(cfg)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, mask)
        h = F.gelu(self.intermediate.dense(x))      # BERT's gelu is erf's
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEncoder(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class MiniLM(nn.Module):
    """The BERT encoder (HF BertModel's parameter names, without the
    pooler); forward returns the last hidden state (B, T, D)."""

    def __init__(self, cfg: MiniLMConfig = MiniLMConfig(),
                 device: DeviceLike = "cuda"):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)
        for m in self.modules():       # BERT's initialiser
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, std=0.02)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
        self.eval().to(dev)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.encoder.layer:
            x = layer(x, attention_mask)
        return x


def mean_pool(hidden: torch.Tensor, attention_mask: torch.Tensor
              ) -> torch.Tensor:
    """SentenceTransformer Pooling(mean): (B, T, D), (B, T) -> (B, D)."""
    m = attention_mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(1) / m.sum(1).clamp(min=1e-9)


def bert_state_dict(state_dict: Dict, model: MiniLM) -> Dict:
    """The tensors `model` holds, from a BertModel or sentence-transformers
    state dict (keys bare, ``bert.``- or ``0.auto_model.``-prefixed).
    Extra keys (the pooler, position_ids) are ignored; a missing one
    raises."""
    sd = {}
    for k, v in state_dict.items():
        for prefix in ("0.auto_model.", "bert."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        sd[k] = v
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"the state dict lacks {len(missing)} MiniLM tensors, "
                       f"e.g. {missing[:3]}")
    return {k: sd[k] for k in wanted}


# ---- WordPiece tokenizer (host) -------------------------------------------

def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class WordPieceTokenizer:
    """HF BertTokenizer semantics: basic tokenizer (clean, CJK spacing,
    lowercase + accent strip, punctuation split) + greedy longest-match
    WordPiece with '##' continuations."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.max_input_chars_per_word = max_input_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(ch for ch in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(ch) != "Mn")
            cur: List[str] = []           # split on punctuation
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        tokens.append("".join(cur))
                        cur = []
                    tokens.append(ch)
                else:
                    cur.append(ch)
            if cur:
                tokens.append("".join(cur))
        return tokens

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for t in self._basic_tokenize(text)
                for p in self._wordpiece(t)]

    def encode(self, text: str, max_length: int) -> List[int]:
        """[CLS] ids [SEP], truncated to max_length."""
        ids = [self.vocab[p] for p in self.tokenize(text)]
        return [self.cls_id] + ids[:max_length - 2] + [self.sep_id]


# ---- serving encoder ------------------------------------------------------

def _bucket(n: int, lo: int, hi: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


class MiniLMEncoder:
    """texts -> (n, D) float32 sentence embeddings, computed on the
    model's device.

    The (batch, length) of the token ids is padded up to power-of-two
    buckets, as in the JAX package (where a bucket is one XLA compile): a
    text then meets the same GEMM shapes whatever else shares its batch,
    within a bucket. Empty strings embed as [CLS][SEP], like
    SentenceTransformer.encode("")."""

    def __init__(self, model: MiniLM, tokenizer: WordPieceTokenizer,
                 min_len: int = 16, min_batch: int = 8):
        self.model = model
        self.tokenizer = tokenizer
        self.min_len = min_len
        self.min_batch = min_batch

    @torch.no_grad()
    def encode(self, texts: List[str]) -> np.ndarray:
        cfg = self.model.cfg
        if not texts:
            return np.zeros((0, cfg.hidden_size), np.float32)
        seqs = [self.tokenizer.encode(t, cfg.max_seq_length) for t in texts]
        L = _bucket(max(len(s) for s in seqs), self.min_len,
                    cfg.max_seq_length)
        B = _bucket(len(seqs), self.min_batch, 1 << 30)
        ids = np.full((B, L), self.tokenizer.pad_id, np.int64)
        mask = np.zeros((B, L), np.int64)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        dev = self.model.device
        ids, mask = to_device(ids, dev), to_device(mask, dev)
        out = mean_pool(self.model(ids, mask), mask)
        return out[:len(seqs)].cpu().numpy()

    def __call__(self, texts: List[str]) -> np.ndarray:
        return self.encode(texts)


def load_minilm(path: str, device: DeviceLike = "cuda",
                **encoder_kw) -> MiniLMEncoder:
    """Load a sentence-transformers / HF MiniLM checkpoint directory
    (config.json + vocab.txt + pytorch_model.bin or model.safetensors)
    into a MiniLMEncoder on `device`."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        raw = json.load(f)
    cfg = MiniLMConfig(
        vocab_size=raw.get("vocab_size", 30522),
        hidden_size=raw.get("hidden_size", 384),
        num_layers=raw.get("num_hidden_layers", 6),
        num_heads=raw.get("num_attention_heads", 12),
        intermediate_size=raw.get("intermediate_size", 1536),
        max_position_embeddings=raw.get("max_position_embeddings", 512),
        type_vocab_size=raw.get("type_vocab_size", 2),
        layer_norm_eps=raw.get("layer_norm_eps", 1e-12))
    # sentence_bert_config.json carries the truncation length (128)
    sb_cfg = os.path.join(path, "sentence_bert_config.json")
    if os.path.exists(sb_cfg):
        with open(sb_cfg, encoding="utf-8") as f:
            msl = json.load(f).get("max_seq_length")
        if msl:
            cfg = dataclasses.replace(cfg, max_seq_length=msl)

    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(bin_path):
        state_dict = torch.load(bin_path, map_location="cpu",
                                weights_only=True)
    elif os.path.exists(st_path):
        from safetensors.torch import load_file
        state_dict = load_file(st_path)
    else:
        raise FileNotFoundError(
            f"no pytorch_model.bin or model.safetensors under {path}")
    model = MiniLM(cfg, device=device)
    model.load_state_dict(bert_state_dict(state_dict, model))

    do_lower = True
    tok_cfg = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(tok_cfg):
        with open(tok_cfg, encoding="utf-8") as f:
            do_lower = json.load(f).get("do_lower_case", True)
    tokenizer = WordPieceTokenizer.from_vocab_file(
        os.path.join(path, "vocab.txt"), do_lower_case=do_lower)
    return MiniLMEncoder(model, tokenizer, **encoder_kw)
