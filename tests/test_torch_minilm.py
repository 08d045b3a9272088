"""Text ingress: the port's MiniLM (models/minilm.py), its tokenizer,
load_minilm, context_slots and TranscriptContextStager against the JAX
package's, on the same seeded ids, weights and transcripts (a 2-layer,
48-wide model, tests/test_minilm.py's)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qpgesture_tpu.models import minilm as jm
from qpgesture_tpu.pipelines import database_builder as jax_builder
from qpgesture_tpu.serve import TranscriptContextStager as JaxStager
from qpgesture_tpu_torch.models import minilm as pm
from qpgesture_tpu_torch.models.convert import minilm_state_dict_from_jax
from qpgesture_tpu_torch.pipelines import database_builder as port_builder
from qpgesture_tpu_torch.serve import TranscriptContextStager

from test_minilm import SMALL, VOCAB

PCFG = pm.MiniLMConfig(**{f: getattr(SMALL, f) for f in (
    "vocab_size", "hidden_size", "num_layers", "num_heads",
    "intermediate_size", "max_position_embeddings", "type_vocab_size",
    "layer_norm_eps", "max_seq_length")})
# float32 on both sides, other summation orders through 2 layers
ATOL = 1e-5
WORDS = [(0.1, 0.4, "hello"), (0.5, 0.9, "world"), (1.2, 1.6, "this"),
         (2.0, 2.3, "is"), (2.4, 2.9, "a"), (3.1, 3.5, "test"),
         (3.9, 4.2, "the"), (4.5, 5.0, "quick"), (6.5, 7.0, "fox"),
         (7.2, 7.9, "wave"), (9.1, 9.4, "hand")]


def _jax_params(seed=0):
    ids = jnp.zeros((1, 8), jnp.int32)
    variables = jm.MiniLMJax(SMALL).init(jax.random.PRNGKey(seed), ids, ids)
    return jax.tree_util.tree_map(np.asarray, variables)


def _port_model(variables):
    model = pm.MiniLM(PCFG, device="cpu")
    model.load_state_dict(minilm_state_dict_from_jax(variables, PCFG))
    return model


def _ids_mask(seed=3, B=3, T=17, lengths=(17, 9, 5)):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL.vocab_size, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return ids, mask


def test_minilm_stack_matches_jax():
    """JAX-initialised weights carried across by minilm_state_dict_from_jax:
    hidden states of real tokens and mean-pooled embeddings within 1e-5."""
    variables = _jax_params()
    model = _port_model(variables)
    ids, mask = _ids_mask()
    want = np.asarray(jm.MiniLMJax(SMALL).apply(variables, jnp.asarray(ids),
                                                jnp.asarray(mask)))
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    got = model(ids_t, mask_t)
    assert got.shape == want.shape == (3, 17, 48)
    np.testing.assert_allclose(got.numpy()[mask > 0], want[mask > 0],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        pm.mean_pool(got, mask_t).numpy(),
        np.asarray(jm.mean_pool(jnp.asarray(want), jnp.asarray(mask))),
        rtol=0, atol=ATOL)
    # token types reach the embedding as in JAX
    tt = (np.arange(17)[None] % 2).repeat(3, 0).astype(np.int32)
    want_tt = np.asarray(jm.MiniLMJax(SMALL).apply(
        variables, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(tt)))
    got_tt = model(ids_t, mask_t, torch.from_numpy(tt).long()).numpy()
    np.testing.assert_allclose(got_tt[mask > 0], want_tt[mask > 0], rtol=0,
                               atol=ATOL)


def test_state_dict_round_trips_through_jax_converter():
    """The port's parameter names are HF BERT's: the JAX package's own
    convert_minilm reads the port's state dict, with or without the
    sentence-transformers prefix, back to the same parameters."""
    variables = _jax_params(seed=4)
    sd = {k: v.numpy() for k, v in
          minilm_state_dict_from_jax(variables, PCFG).items()}
    for prefix in ("", "0.auto_model."):
        back = jm.convert_minilm({prefix + k: v for k, v in sd.items()},
                                 SMALL)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                               variables)


@pytest.mark.parametrize("text", [
    "The quick brown fox jumps over the lazy dog.",
    "Hello, world! unaffable runner",
    "CAFE cafe Café",
    "",
    "zzzzz qqq",
    "a,b.c!  weird   spacing\tand\ncontrol",
    "word-with-dashes it's 'quoted'",
    "中文 mixed 字",
])
def test_wordpiece_ids_match_jax(tmp_path, text):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    mine = pm.WordPieceTokenizer.from_vocab_file(str(vocab_file))
    theirs = jm.WordPieceTokenizer.from_vocab_file(str(vocab_file))
    assert mine.tokenize(text) == theirs.tokenize(text)
    for max_len in (SMALL.max_seq_length, 5):
        assert mine.encode(text, max_len) == theirs.encode(text, max_len)


def _write_checkpoint(path, sd, safetensors=False, extra=None):
    os.makedirs(path, exist_ok=True)
    if safetensors:
        from safetensors.torch import save_file
        save_file({k: v.contiguous() for k, v in sd.items()},
                  os.path.join(path, "model.safetensors"))
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": SMALL.vocab_size,
                   "hidden_size": SMALL.hidden_size,
                   "num_hidden_layers": SMALL.num_layers,
                   "num_attention_heads": SMALL.num_heads,
                   "intermediate_size": SMALL.intermediate_size,
                   "max_position_embeddings":
                       SMALL.max_position_embeddings, **(extra or {})}, f)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    with open(os.path.join(path, "sentence_bert_config.json"), "w") as f:
        json.dump({"max_seq_length": SMALL.max_seq_length}, f)


TEXTS = ["the quick brown fox", "hello world!", "",
         "unaffable runner jumps over the lazy dog"]


@pytest.mark.parametrize("layout", ["bin", "prefixed_bin", "safetensors"])
def test_load_minilm_matches_jax_loader(tmp_path, layout):
    """One checkpoint directory read by both packages' load_minilm (the
    sentence-transformers layout has the 0.auto_model. prefix and a pooler
    the encoder does not use): embeddings within 1e-5, the truncation
    length from sentence_bert_config.json."""
    sd = minilm_state_dict_from_jax(_jax_params(seed=1), PCFG)
    if layout == "prefixed_bin":
        sd = {f"0.auto_model.{k}": v for k, v in sd.items()}
        sd["0.auto_model.pooler.dense.weight"] = torch.zeros(48, 48)
    ckpt = str(tmp_path / "minilm")
    _write_checkpoint(ckpt, sd, safetensors=layout == "safetensors")
    enc = pm.load_minilm(ckpt, device="cpu")
    assert enc.model.cfg == PCFG
    got = enc.encode(TEXTS)
    assert got.shape == (4, 48) and got.dtype == np.float32
    if layout != "safetensors":   # the JAX loader reads safetensors as numpy
        np.testing.assert_allclose(got, jm.load_minilm(ckpt).encode(TEXTS),
                                   rtol=0, atol=ATOL)
    with pytest.raises(KeyError, match="lacks"):
        pm.bert_state_dict({}, enc.model)


def test_encoder_empty_batch_and_buckets(tmp_path):
    """An empty batch gives (0, D); a text embeds the same alone and in a
    batch (both in the (8, 16) bucket), and batches of 9 texts pad to 16
    rows, as in JAX."""
    ckpt = str(tmp_path / "m")
    _write_checkpoint(ckpt, minilm_state_dict_from_jax(_jax_params(), PCFG))
    enc = pm.load_minilm(ckpt, device="cpu")
    assert enc.encode([]).shape == (0, 48)
    batch = enc.encode(TEXTS)
    np.testing.assert_array_equal(enc.encode([TEXTS[3]])[0], batch[3])
    assert pm._bucket(9, 8, 1 << 30) == 16 == jm._bucket(9, 8, 1 << 30)
    nine = enc.encode(TEXTS * 2 + ["a b c"])
    np.testing.assert_allclose(nine, jm.load_minilm(ckpt).encode(
        TEXTS * 2 + ["a b c"]), rtol=0, atol=ATOL)


def test_context_slots_match_jax():
    for w in range(3):
        assert port_builder.context_slots(WORDS, 4.0 * w, 4.0 * w + 4) == \
            jax_builder.context_slots(WORDS, 4.0 * w, 4.0 * w + 4)
    assert port_builder.context_slots(WORDS, 0, 4, num_codes=10,
                                      step_sz=2) == \
        jax_builder.context_slots(WORDS, 0, 4, num_codes=10, step_sz=2)


def test_transcript_stager_matches_jax(tmp_path):
    """stage and stage_window equal the JAX stager's for the same embed_fn
    (the hashed embedding, bit-equal), and with each package's MiniLM on
    one checkpoint within 1e-5; one embed call per stage, of distinct
    texts."""
    embed = port_builder.hashed_embed_fn(dim=16)
    calls = []

    def counting(texts):
        calls.append(list(texts))
        return embed(texts)

    mine, theirs = TranscriptContextStager(counting), JaxStager(embed)
    got = mine.stage(WORDS, 3)
    assert got.shape == (3, 30, 16) and len(calls) == 1
    assert len(calls[0]) == len(set(calls[0]))
    np.testing.assert_array_equal(got, theirs.stage(WORDS, 3))
    for w in range(3):
        np.testing.assert_array_equal(mine.stage_window(WORDS, w),
                                      theirs.stage_window(WORDS, w))

    ckpt = str(tmp_path / "m")
    _write_checkpoint(ckpt, minilm_state_dict_from_jax(_jax_params(2), PCFG))
    got = TranscriptContextStager(
        port_builder.minilm_embed_fn(ckpt, device="cpu")).stage(WORDS, 3)
    want = JaxStager(jax_builder.minilm_embed_fn(ckpt)).stage(WORDS, 3)
    assert got.shape == want.shape == (3, 30, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
